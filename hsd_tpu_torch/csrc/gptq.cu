// GPTQ dequantize-and-matvec kernels for Hopper (sm_90a).
//
// Hand-written counterparts of the fused Pallas kernels in
// hsd_tpu/ops/gptq_pallas.py for packed int4 weights with f32 operands:
//   K2  _kernel_attn_mlp_int4  the layer tail, as three launches of this template
//   K6  _kernel_mlp_int4       the SwiGLU MLP, as K2's last two launches
// (The single products, K1 _kernel_int4_ln and K3 _kernel_int4 for packed
// int4 and K4 and K5 for int8, are csrc/gptq_i8.cu, on the tensor cores.)
//
// One template covers them both. A block owns kCols output columns for up to
// NR activation rows and walks the whole input dimension in tiles of kTile
// weight rows. Each lane loads 4 consecutive weight bytes of a row (one
// 128-byte coalesced transaction per warp and row), dequantizes them in
// registers and accumulates in f32. The eight warps of a block split every
// tile's rows between them and are summed in a fixed order at the end, so a
// row's result never depends on how many rows were launched with it: the
// same bits at 1, 11 or 63 rows. No floating-point atomics.
//
// Narrow outputs (the 14B wqkv, wo and wdown) give
// too few column blocks to fill 132 SMs, so the input dimension is split
// across `splits` blocks (blockIdx.z) chosen from the weight's shape and the
// card alone, never from the row count. Each split writes its f32 partial to
// a workspace and a second kernel sums the splits in order, then applies the
// epilogue.
//
// Layouts (ops/linear.py of the port, same as the JAX package):
//   packed int4: w [din/2, dout] uint8, split-half: the low nibble of byte
//     row r is input row r, the high nibble input row r + din/2, both stored
//     as code + 8. Weight = (nibble - 8 - zero) * scale.
//   scales, zeros: [groups, dout]; group g covers input rows [g*gs, (g+1)*gs).
//
// Prologues, applied while an activation tile is staged in shared memory:
//   PRO_NONE  x as given (bf16 or f32)
//   PRO_RMS   x * rsqrt(mean(x^2) + eps) * ln: a one-block-per-row pass
//             first writes each row's inverse RMS (n floats), which every
//             block of the matvec then reads
//   PRO_SILU  silu(g) * u with g = x[:, :din], u = x[:, din:2*din] (f32)
// Epilogue: optional residual add (bf16 or f32), output bf16 or f32.
//
// Bound on the card: every call streams the weight once, which at decode row
// counts is all the bytes there are (3.35 TB/s on an H100 SXM). The design
// keeps every weight byte in registers only, prefetches the next tile's
// weight words while the current tile computes, and keeps intermediates of
// the layer tail in f32 device buffers of at most 32 x 27648 x 4 bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 128;                      // output columns per block
constexpr int kTile = 128;                      // weight rows per tile
constexpr int kSteps = kTile / (4 * kWarps);    // 4-row steps per warp and tile
constexpr int kRedRows = 4;                     // rows per reduction pass
constexpr int kErrShape = 100000;               // unsupported shape

enum { PRO_NONE = 0, PRO_RMS = 1, PRO_SILU = 2 };

struct Args {
  const void* x;
  int x_bf16;
  long long ldx;        // row stride of x in elements
  int n;                // activation rows
  int din;              // logical input features
  const uint8_t* w;
  int dout;
  const void* scales;
  int s_bf16;
  const float* zeros;   // may be null
  int groups;
  const float* ln;      // PRO_RMS only
  float eps;
  float* inv_rms;       // PRO_RMS only: [n] inverse RMS of each row
  const void* resid;    // may be null; [n, dout]
  int r_bf16;
  void* out;            // [n, dout]
  int o_bf16;
  int splits;           // input-dimension splits (blockIdx.z)
  float* ws;            // [splits, n, dout] f32 partials when splits > 1
};

__device__ __forceinline__ float load_val(const void* p, int bf16, long long i) {
  if (bf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_val(void* p, int bf16, long long i, float v) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

// Four weight bytes of row `row` starting at column `col` (zero past dout).
__device__ __forceinline__ uint32_t load_w4(const Args& a, int row, int col, bool vec) {
  const uint8_t* p = a.w + (long long)row * a.dout + col;
  if (vec) {
    if (col >= a.dout) return 0u;
    return __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  uint32_t v = 0u;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    if (col + c < a.dout) v |= (uint32_t)__ldg(p + c) << (8 * c);
  }
  return v;
}

template <int NR, int PRO>
__global__ void __launch_bounds__(kThreads)
gptq_matvec_kernel(const Args a) {
  constexpr int P = 2;                              // activation planes (nibbles)
  __shared__ __align__(16) float xs[NR * P * kTile];
  __shared__ __align__(16) float red[kWarps * kRedRows * kCols];
  __shared__ float inv_rms[NR];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int col0 = blockIdx.x * kCols + lane * 4;
  const int row0 = blockIdx.y * NR;
  const int nrows = min(NR, a.n - row0);
  const int R = a.din / 2;                         // weight rows
  const int gs = a.din / a.groups;
  const bool vec = (a.dout % 4) == 0;

  if (PRO == PRO_RMS && tid < NR) inv_rms[tid] = tid < nrows ? a.inv_rms[row0 + tid] : 0.f;

  float acc[NR][4];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  }

  const int ntiles = R / kTile;
  const int per_split = (ntiles + a.splits - 1) / a.splits;
  const int t_begin = blockIdx.z * per_split;
  const int t_end = min(ntiles, t_begin + per_split);
  uint32_t wcur[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      wcur[j][i] = (t_begin < t_end)
          ? load_w4(a, t_begin * kTile + 4 * (warp + kWarps * j) + i, col0, vec) : 0u;
    }
  }

  for (int t = t_begin; t < t_end; ++t) {
    const int t0 = t * kTile;
    __syncthreads();   // the previous tile's activations are consumed (and inv_rms is ready)
    for (int e = tid; e < NR * P * kTile; e += kThreads) {
      const int k = e % kTile;
      const int rp = e / kTile;
      const int p = rp % P;
      const int r = rp / P;
      const int f = p * R + t0 + k;                  // feature of this element
      float v = 0.f;
      if (r < nrows) {
        const long long xi = (long long)(row0 + r) * a.ldx + f;
        if (PRO == PRO_SILU) {
          const float g = load_val(a.x, a.x_bf16, xi);
          const float u = load_val(a.x, a.x_bf16, xi + a.din);
          v = g * (1.f / (1.f + expf(-g))) * u;
        } else {
          v = load_val(a.x, a.x_bf16, xi);
          if (PRO == PRO_RMS) v = v * inv_rms[r] * a.ln[f];
        }
      }
      xs[e] = v;                                     // [(r * P + p) * kTile + k]
    }

    // this tile's scales and zero points: one group per plane
    float s_lo[4], s_hi[4], z_lo[4], z_hi[4];
    {
      const int g_lo = t0 / gs;
      const int g_hi = (R + t0) / gs;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = col0 + c;
        const bool ok = col < a.dout;
        const long long i_lo = (long long)g_lo * a.dout + col;
        const long long i_hi = (long long)g_hi * a.dout + col;
        s_lo[c] = ok ? load_val(a.scales, a.s_bf16, i_lo) : 0.f;
        s_hi[c] = ok ? load_val(a.scales, a.s_bf16, i_hi) : 0.f;
        z_lo[c] = (ok && a.zeros) ? a.zeros[i_lo] : 0.f;
        z_hi[c] = (ok && a.zeros) ? a.zeros[i_hi] : 0.f;
      }
    }

    // prefetch the next tile's weight words while this one computes
    uint32_t wnext[kSteps][4];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wnext[j][i] = (t + 1 < t_end)
            ? load_w4(a, t0 + kTile + 4 * (warp + kWarps * j) + i, col0, vec) : 0u;
      }
    }
    __syncthreads();   // activations staged

#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int rr = 4 * (warp + kWarps * j);        // first row of this step in the tile
      // dequantize the step's 4 rows x 4 columns once, reuse them for every row
      float wl[4][4], wh[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t wv = wcur[j][i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const uint32_t b = (wv >> (8 * c)) & 0xffu;
          wl[i][c] = ((float)((int)(b & 15u) - 8) - z_lo[c]) * s_lo[c];
          wh[i][c] = ((float)((int)(b >> 4) - 8) - z_hi[c]) * s_hi[c];
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const float4 e4 = *reinterpret_cast<const float4*>(&xs[(r * P) * kTile + rr]);
        const float xe[4] = {e4.x, e4.y, e4.z, e4.w};
        const float4 o4 = *reinterpret_cast<const float4*>(&xs[(r * P + P - 1) * kTile + rr]);
        const float xo[4] = {o4.x, o4.y, o4.z, o4.w};
        // rows in order, low plane before high plane: the same sequence of
        // fused multiply-adds for every activation row, whatever NR is
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[r][c] = fmaf(xe[i], wl[i][c], acc[r][c]);
            acc[r][c] = fmaf(xo[i], wh[i][c], acc[r][c]);
          }
        }
      }
    }

#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) wcur[j][i] = wnext[j][i];
    }
  }

  // sum the warps' partials in a fixed order, then the epilogue
#pragma unroll
  for (int r0 = 0; r0 < NR; r0 += kRedRows) {
    __syncthreads();
#pragma unroll
    for (int rr = 0; rr < kRedRows; ++rr) {
      if (r0 + rr < NR) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          red[(warp * kRedRows + rr) * kCols + lane * 4 + c] = acc[r0 + rr < NR ? r0 + rr : 0][c];
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < kRedRows * kCols; e += kThreads) {
      const int rr = e / kCols;
      const int cc = e % kCols;
      const int r = r0 + rr;
      const int col = blockIdx.x * kCols + cc;
      if (r < NR && r < nrows && col < a.dout) {
        float s = red[rr * kCols + cc];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += red[(w * kRedRows + rr) * kCols + cc];
        const long long oi = (long long)(row0 + r) * a.dout + col;
        if (a.splits > 1) {
          a.ws[(long long)blockIdx.z * a.n * a.dout + oi] = s;
        } else {
          if (a.resid) s = load_val(a.resid, a.r_bf16, oi) + s;
          store_val(a.out, a.o_bf16, oi, s);
        }
      }
    }
  }
}

// Inverse RMS of row blockIdx.x over its din features, summed in a fixed
// order (lanes, then warps in order).
__global__ void __launch_bounds__(kThreads) inv_rms_kernel(const Args a) {
  __shared__ float part[kWarps];
  const long long base = (long long)blockIdx.x * a.ldx;
  float s = 0.f;
  for (int f = threadIdx.x; f < a.din; f += kThreads) {
    const float v = load_val(a.x, a.x_bf16, base + f);
    s = fmaf(v, v, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = part[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) t += part[w];
    a.inv_rms[blockIdx.x] = rsqrtf(t / (float)a.din + a.eps);
  }
}

// Sum the splits' partials in split order, then the epilogue.
__global__ void __launch_bounds__(kThreads) splitk_reduce_kernel(const Args a) {
  const long long total = (long long)a.n * a.dout;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (long long)gridDim.x * kThreads) {
    float s = a.ws[i];
    for (int z = 1; z < a.splits; ++z) s += a.ws[z * total + i];
    if (a.resid) s = load_val(a.resid, a.r_bf16, i) + s;
    store_val(a.out, a.o_bf16, i, s);
  }
}

template <int PRO>
void launch_rows(int nr, dim3 grid, cudaStream_t stream, const Args& a) {
  switch (nr) {
    case 1: gptq_matvec_kernel<1, PRO><<<grid, kThreads, 0, stream>>>(a); break;
    case 2: gptq_matvec_kernel<2, PRO><<<grid, kThreads, 0, stream>>>(a); break;
    case 4: gptq_matvec_kernel<4, PRO><<<grid, kThreads, 0, stream>>>(a); break;
    case 8: gptq_matvec_kernel<8, PRO><<<grid, kThreads, 0, stream>>>(a); break;
    default: gptq_matvec_kernel<16, PRO><<<grid, kThreads, 0, stream>>>(a); break;
  }
}

}  // namespace

// y[n, dout] = prologue(x) @ deq(w) (+ resid), w packed int4, with the input
// dimension split over `splits` blocks. Workspaces, allocated by the caller:
// ws [splits, n, dout] f32 (unused when splits == 1) and inv [n] f32
// (PRO_RMS only). Returns 0, a CUDA error code from a launch, or kErrShape
// for a shape the kernel does not take.
extern "C" int hsd_gptq_matvec(const void* x, int x_bf16, long long ldx, int n,
                               int din, const void* w, int dout,
                               const void* scales, int s_bf16, const void* zeros,
                               int groups, const void* ln, float eps, int prologue,
                               const void* resid, int r_bf16, void* out, int o_bf16,
                               int splits, void* ws, void* inv, void* stream) {
  if (n <= 0 || din <= 0 || dout <= 0 || groups <= 0 || din % groups) return kErrShape;
  const int gs = din / groups;
  if (gs % kTile) return kErrShape;
  if (din % (2 * kTile)) return kErrShape;
  if (prologue == PRO_RMS && (!ln || !inv)) return kErrShape;
  const int ntiles = din / 2 / kTile;
  if (splits < 1 || splits > ntiles || (splits > 1 && !ws)) return kErrShape;

  Args a;
  a.x = x; a.x_bf16 = x_bf16; a.ldx = ldx; a.n = n; a.din = din;
  a.w = reinterpret_cast<const uint8_t*>(w); a.dout = dout;
  a.scales = scales; a.s_bf16 = s_bf16;
  a.zeros = reinterpret_cast<const float*>(zeros); a.groups = groups;
  a.ln = reinterpret_cast<const float*>(ln); a.eps = eps;
  a.inv_rms = reinterpret_cast<float*>(inv);
  a.resid = resid; a.r_bf16 = r_bf16; a.out = out; a.o_bf16 = o_bf16;
  a.splits = splits; a.ws = reinterpret_cast<float*>(ws);

  const int nr = n >= 9 ? 16 : n >= 5 ? 8 : n >= 3 ? 4 : n;
  const dim3 grid((dout + kCols - 1) / kCols, (n + nr - 1) / nr, splits);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (prologue == PRO_RMS) {
    inv_rms_kernel<<<n, kThreads, 0, s>>>(a);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (prologue == PRO_RMS) launch_rows<PRO_RMS>(nr, grid, s, a);
  else if (prologue == PRO_SILU) launch_rows<PRO_SILU>(nr, grid, s, a);
  else launch_rows<PRO_NONE>(nr, grid, s, a);
  int err = (int)cudaGetLastError();
  if (err || splits == 1) return err;
  const long long total = (long long)n * dout;
  const int blocks = (int)((total + kThreads - 1) / kThreads < 1024
                           ? (total + kThreads - 1) / kThreads : 1024);
  splitk_reduce_kernel<<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* hsd_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the GPTQ matvec kernel";
  return cudaGetErrorString((cudaError_t)code);
}
