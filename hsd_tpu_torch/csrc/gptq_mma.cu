// K7 and K7i4: int8 and packed-int4 dequantize-and-matmul on the tensor
// cores for Hopper (sm_90a), optionally with the RMSNorm fused in the
// activation read.
//
// Hand-written counterpart of the `mxu_bf16=True` mode of the Pallas kernels
// `_kernel`, `_kernel_ln` (int8), `_kernel_int4` and `_kernel_int4_ln`
// (packed int4) in hsd_tpu/ops/gptq_pallas.py, with the rank-1 correction
// that gptq_matmul subtracts outside them (:500-526): both dot operands are
// rounded to bf16 and the product accumulates in f32. The weight rounds
// after its f32 dequantization code * scale, with the code AS STORED: the
// signed int8 code, or the UNSIGNED nibble (code + 8, 0..15) of packed int4
// (folding the -8 into the staged weight would round differently). The
// activations round after the norm (x * rsqrt(mean(x^2) + eps) * ln, f32).
// The correction sum_g xg[g] * (zero[g] + off) * scale[g] is subtracted in
// f32 (off = 8 for packed int4, 0 for int8; zero = 0 for symmetric
// weights), xg the group sums of the UNROUNDED f32 (normed) activations, and
// the result rounds once to bf16.
//
// Regime: the slot-batched EAGLE tree forward stacks 8 slots x 60 trie tokens
// = 480 rows. There the product is bound by operations, not by the weight
// stream (at Llama-3.1-8B widths 6.7 TFLOP a pool step against 7.5 GB of
// int8 or 3.8 GB of int4 weights), so it runs on the bf16 tensor cores.
//
// Design: a block owns a 128-row x 128-column output tile and walks the whole
// input dimension in k-slices of 64. For each slice it stages the activations
// (normed in f32 first when ln is given) as bf16 in shared memory, row-major,
// and the dequantized weight (code -> f32 code * scale -> bf16) transposed,
// column-major, so that ldmatrix hands both mma.sync fragments over without a
// transpose. The weight format is the kernel's template parameter. A packed
// slice reads one nibble plane: with the split-half layout input row k <
// din/2 is the low nibble of byte row k and row k >= din/2 the high nibble
// of byte row k - din/2, and a 64-wide slice never straddles din/2 (din/2 is
// a multiple of the group size, itself a multiple of 64); its scales are the
// plane's own groups. Activations arrive as 16-byte vector loads. The next
// slice's global loads are in flight while the eight warps (2 x 4, each
// 64 x 32 outputs) run mma.sync m16n8k16 bf16 -> f32. Row tiles are the
// fastest grid axis, so the blocks that share a weight tile run together and
// read it from L2 after the first. A one-block-per-row pre-pass writes the
// row's inverse RMS (with ln) and its group sums xg (with a correction),
// each in a fixed order. At a group's first k-slice the block stages the
// tile's xg and (zero + off) * scale beside the tiles, from the scales the
// weight loader already holds, and every accumulator takes the group's
// rank-1 correction (fmaf, f32) before the group's products, groups in
// order; a symmetric int8 weight compiles without it. The k order of every
// output is fixed, and no block sums another's partials: a row's bits
// do not depend on how many rows share the launch. No floating-point
// atomics. Ragged rows and columns are masked.
//
// Layouts (ops/linear.py of the port): w [din, dout] int8 codes, or
// [din/2, dout] uint8 split-half nibbles; scales [groups, dout] (bf16 or
// f32); zeros [groups, dout] f32 or null; group g covers input rows
// [g*gs, (g+1)*gs), gs a multiple of 64. x [n, din] bf16, 16-byte aligned;
// ln [din] f32; the output [n, dout] bf16. (The bf16-operand mode is taken
// by bf16 models only; an f32-activation variant waits for a configuration
// that needs it.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // output rows per block
constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // input features per k-slice
constexpr int LDS = BK + 8;             // shared row stride (bf16): no bank conflicts
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kErrShape = 100000;       // unsupported shape

struct Args {
  const __nv_bfloat16* x;
  int n;                // activation rows
  int din;
  const uint8_t* w;
  int dout;
  const void* scales;
  int s_bf16;
  int groups;
  const float* ln;      // null: no norm
  float eps;
  float* inv;           // [n] inverse RMS of each row (ln only)
  __nv_bfloat16* out;   // [n, dout]
  // the correction, after the fields the symmetric int8 kernel reads
  const float* zeros;   // null: symmetric
  float* xg;            // [n, groups] group sums (null: no correction)
  float off;            // the correction's offset on the zero point
};

__device__ __forceinline__ float load_val(const void* p, int bf16, long long i) {
  if (bf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

// two f32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory; lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Activations of one k-slice between their global loads and their shared
// stores: 32 consecutive bf16 features of one row.
struct XSlice {
  uint4 v[4];
  __device__ __forceinline__ void load(const Args& a, long long i, bool ok) {
    const uint4* p = reinterpret_cast<const uint4*>(a.x + i);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = ok ? __ldg(p + j) : make_uint4(0u, 0u, 0u, 0u);
  }
  __device__ __forceinline__ float get(int e) const {
    const uint32_t w = reinterpret_cast<const uint32_t*>(v)[e >> 1];
    const unsigned short h = (e & 1) ? (unsigned short)(w >> 16) : (unsigned short)(w & 0xffffu);
    return __bfloat162float(__ushort_as_bfloat16(h));
  }
  __device__ __forceinline__ uint32_t raw_pair(int i) const {
    return reinterpret_cast<const uint32_t*>(v)[i];
  }
};

// kPacked: split-half nibbles, else int8 codes; kCorr: a correction (packed
// or zero points) to subtract, else none (symmetric int8).
template <bool kPacked, bool kCorr>
__global__ void __launch_bounds__(kThreads, 2) mma_kernel(const Args a) {
  __shared__ __align__(16) __nv_bfloat16 As[BM * LDS];   // [row][k]
  __shared__ __align__(16) __nv_bfloat16 Bs[BN * LDS];   // [col][k]
  // kCorr: the current group's xg of the tile's rows [0, BM), then its
  // columns' (zero + off) * scale [BM, BM + BN)
  __shared__ float Cs[kCorr ? BM + BN : 1];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const int gs = a.din / a.groups;
  const int nslices = a.din / BK;
  const int half = a.din / 2;           // packed: the high plane's first row
  const bool vec = (a.dout % 4) == 0;

  // loaders: activations of row ar, features [ak, ak + 32) of the slice;
  // weight rows [bk, bk + 8) of the slice, columns [bc, bc + 4)
  const int ar = tid >> 1;
  const int ak = (tid & 1) * 32;
  const int grow = row0 + ar;
  const bool row_ok = grow < a.n;
  const float rinv = (a.ln && row_ok) ? a.inv[grow] : 1.f;
  const int bc = (tid & 31) * 4;
  const int bk = (tid >> 5) * 8;
  const int gcol = col0 + bc;

  // mma: warp tile 64 rows x 32 columns
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  // ldmatrix row addresses: A rows lane % 16, k half lane / 16; B columns
  // (lane % 8) + 8 * (lane / 16), k half (lane / 8) % 2
  const int a_row = wm + (lane & 15);
  const int a_k = (lane >> 4) * 8;
  const int b_col = wn + (lane & 7) + ((lane >> 4) << 3);
  const int b_k = ((lane >> 3) & 1) * 8;
  const int g = lane >> 2;
  const int tg = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  XSlice xs;
  uint32_t wraw[8];
  float sc[4];
  float xgv = 0.f;            // kCorr: row ar's xg of the loaded slice's group
  auto load = [&](int t) {
    const int k0 = t * BK;
    xs.load(a, (long long)grow * a.din + k0 + ak, row_ok);
    // packed: byte rows of the slice's nibble plane
    const int r0 = kPacked && k0 >= half ? k0 - half : k0;
#pragma unroll
    for (int i = 0; i < 8; ++i) wraw[i] = load_w4(a, r0 + bk + i, gcol, vec);
    const long long si = (long long)(k0 / gs) * a.dout + gcol;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sc[c] = (gcol + c < a.dout) ? load_val(a.scales, a.s_bf16, si + c) : 0.f;
    }
    if (kCorr && k0 % gs == 0) {
      xgv = row_ok ? a.xg[(long long)grow * a.groups + k0 / gs] : 0.f;
    }
  };

  auto store = [&](int t) {
    const int k0 = t * BK;
    uint4* xd = reinterpret_cast<uint4*>(&As[ar * LDS + ak]);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int e = 2 * (4 * q + i);
        if (a.ln) {
          const float v0 = xs.get(e) * rinv * a.ln[k0 + ak + e];
          const float v1 = xs.get(e + 1) * rinv * a.ln[k0 + ak + e + 1];
          pr[i] = pack_bf16(v0, v1);
        } else {
          pr[i] = xs.raw_pair(4 * q + i);
        }
      }
      xd[q] = make_uint4(pr[0], pr[1], pr[2], pr[3]);
    }
    if (kPacked) {            // the slice's nibble plane, four columns a word
      const int shift = k0 >= half ? 4 : 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) wraw[i] = (wraw[i] >> shift) & 0x0f0f0f0fu;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint32_t byte = (wraw[i] >> (8 * c)) & 0xffu;
        wv[i] = (kPacked ? (float)byte : (float)(int)(int8_t)byte) * sc[c];
      }
      *reinterpret_cast<uint4*>(&Bs[(bc + c) * LDS + bk]) =
          make_uint4(pack_bf16(wv[0], wv[1]), pack_bf16(wv[2], wv[3]),
                     pack_bf16(wv[4], wv[5]), pack_bf16(wv[6], wv[7]));
    }
    if (kCorr && k0 % gs == 0) {              // a group's first slice
      if (ak == 0) Cs[ar] = xgv;
      if (bk == 0) {
        const long long si = (long long)(k0 / gs) * a.dout + gcol;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float z = (a.zeros && gcol + c < a.dout) ? a.zeros[si + c] : 0.f;
          Cs[BM + bc + c] = (z + a.off) * sc[c];
        }
      }
    }
  };

  load(0);
  for (int t = 0; t < nslices; ++t) {
    __syncthreads();          // the previous slice is consumed
    store(t);
    __syncthreads();          // this slice is staged
    if (t + 1 < nslices) load(t + 1);
    if (kCorr && (t * BK) % gs == 0) {
      // the group's correction, once per group, as a rank-1 update of the
      // accumulators: acc -= xg[row] * (zero + off) * scale[col]
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xr = Cs[wm + mi * 16 + g + 8 * h];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[mi][ni][2 * h + e] =
                  fmaf(-xr, Cs[BM + wn + ni * 8 + tg * 2 + e], acc[mi][ni][2 * h + e]);
            }
        }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(af[mi], &As[(a_row + mi * 16) * LDS + kk + a_k]);
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        ldmatrix_x4(bf[nj], &Bs[(b_col + nj * 16) * LDS + kk + b_k]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
        }
    }
  }

  #pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int r = row0 + wm + mi * 16 + g;
      const int c = col0 + wn + ni * 8 + tg * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = r + 8 * h;
        if (rr >= a.n) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c + e < a.dout) {
            a.out[(long long)rr * a.dout + c + e] = __float2bfloat16_rn(acc[mi][ni][2 * h + e]);
          }
        }
      }
    }
  }
}

// Pre-pass, one block per row: the row's inverse RMS over its din features
// (ln only) and its group sums xg of the f32 activations the kernel stages
// before rounding, x * inv * ln with ln, else x (correction only). Each sum
// in a fixed order: lanes strided over the features, a butterfly over the
// warp, and (RMS) the warps in order; a group belongs to one warp.
__global__ void __launch_bounds__(kThreads) prep_kernel(const Args a) {
  __shared__ float part[kWarps];
  __shared__ float rinv;
  const long long base = (long long)blockIdx.x * a.din;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (a.ln) {
    float s = 0.f;
    for (int f = threadIdx.x; f < a.din; f += kThreads) {
      const float v = __bfloat162float(a.x[base + f]);
      s = fmaf(v, v, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) part[warp] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = part[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) t += part[w];
      rinv = rsqrtf(t / (float)a.din + a.eps);
      a.inv[blockIdx.x] = rinv;
    }
    __syncthreads();
  }
  if (!a.xg) return;
  const int gs = a.din / a.groups;
  for (int gi = warp; gi < a.groups; gi += kWarps) {
    float s = 0.f;
    for (int f = gi * gs + lane; f < (gi + 1) * gs; f += 32) {
      float v = __bfloat162float(a.x[base + f]);
      // the staged value's products, unfused: (x * inv) * ln
      if (a.ln) v = __fmul_rn(__fmul_rn(v, rinv), a.ln[f]);
      s = __fadd_rn(s, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) a.xg[(long long)blockIdx.x * a.groups + gi] = s;
  }
}

}  // namespace

// y[n, dout] = bf16(prologue(x)) @ bf16(code * scale), f32 accumulation,
// less the correction, rounded to bf16; x and y bf16. packed: w holds
// split-half nibbles (off = 8), else int8 codes (off = 0). zeros may be null
// (symmetric); ln may be null (no norm; with ln, zeros must be null and inv
// is an [n] f32 workspace); xg is an [n, groups] f32 workspace, needed when
// packed or with zeros. Returns 0, a CUDA error code from a launch, or
// kErrShape for a shape the kernel does not take.
extern "C" int hsd_gptq_mma(const void* x, int n, int din, const void* w,
                            int packed, int dout, const void* scales,
                            int s_bf16, const void* zeros, int groups,
                            const void* ln, float eps, void* inv, void* xg,
                            void* out, void* stream) {
  if (n <= 0 || din <= 0 || dout <= 0 || groups <= 0 || din % groups) return kErrShape;
  if ((din / groups) % BK) return kErrShape;
  if (packed && (groups % 2)) return kErrShape;   // planes span whole groups
  if (ln && (!inv || zeros)) return kErrShape;
  if ((packed || zeros) && !xg) return kErrShape;
  const long long col_blocks = (dout + BN - 1) / BN;
  if (col_blocks > 65535) return kErrShape;

  Args a;
  a.x = reinterpret_cast<const __nv_bfloat16*>(x); a.n = n; a.din = din;
  a.w = reinterpret_cast<const uint8_t*>(w); a.dout = dout;
  a.scales = scales; a.s_bf16 = s_bf16;
  a.zeros = reinterpret_cast<const float*>(zeros); a.groups = groups;
  a.ln = reinterpret_cast<const float*>(ln); a.eps = eps;
  a.inv = reinterpret_cast<float*>(inv);
  a.xg = (packed || zeros) ? reinterpret_cast<float*>(xg) : nullptr;
  a.off = packed ? 8.f : 0.f;
  a.out = reinterpret_cast<__nv_bfloat16*>(out);

  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (a.ln || a.xg) {
    prep_kernel<<<n, kThreads, 0, s>>>(a);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const dim3 grid((n + BM - 1) / BM, (unsigned)col_blocks);
  if (packed) {
    mma_kernel<true, true><<<grid, kThreads, 0, s>>>(a);
  } else if (a.xg) {
    mma_kernel<false, true><<<grid, kThreads, 0, s>>>(a);
  } else {
    mma_kernel<false, false><<<grid, kThreads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* hsd_mma_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the GPTQ tensor-core kernel";
  return cudaGetErrorString((cudaError_t)code);
}
