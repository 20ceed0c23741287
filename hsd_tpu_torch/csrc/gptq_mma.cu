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
// K7 (int8, k7_mma_kernel). A per-row pre-pass (k7_prep_kernel) writes what
// every column block would otherwise redo: with ln, the row's inverse RMS
// and its normed activations bf16((x * inv) * ln) as an [n, din] matrix;
// with zero points, its group sums xg. The main kernel then reads one bf16
// matrix. A block owns 128 rows x 128 columns (eight warps, two blocks an
// SM) or, where a grid of 256-row blocks keeps half the SMs busy, 256 rows
// (sixteen warps, one block an SM), so each weight slice is converted for
// more rows; the height comes from the shape and the card only
// (ops/gptq_cuda.k7_block_rows). With zero points a block owns 128 rows and
// runs alone on its SM: the correction's registers would spill at two. It walks din in k-slices of 64 through a
// cp.async ring of three (four) stages: stage s holds slice s's activation
// rows and slice s + 1's raw weight bytes (16-, 4- or 1-byte copies, the
// ragged columns zero-filled). In one barrier interval the warps run slice
// t's mma.sync m16n8k16 bf16 -> f32 on its rows and on the converted tile
// Bs[t % 2] ([col][k]), convert slice t + 1's bytes (code -> exact f32 ->
// * scale -> bf16) into Bs[(t + 1) % 2], and issue step t + 2's (t + 3's)
// copies; the scales, zero points and xg of a group are fetched one slice
// ahead into registers. At a group's first slice the accumulators take its
// rank-1 correction (acc -= xg * zero * scale, fmaf) before its products,
// from a correction tile double-buffered by group parity.
//
// K7i4 (packed int4, mma_kernel<true, true>, the first design). A block owns a
// 128-row x 128-column output tile and walks the whole input dimension in
// k-slices of 64. For each slice it stages the activations (normed in f32
// first when ln is given) as bf16 in shared memory, row-major, and the
// dequantized weight (nibble -> f32 nibble * scale -> bf16) transposed,
// column-major, so that ldmatrix hands both mma.sync fragments over without
// a transpose. With the split-half layout input row k < din/2 is the low
// nibble of byte row k and row k >= din/2 the high nibble of byte row
// k - din/2, and a 64-wide slice never straddles din/2 (din/2 is a multiple
// of the group size, itself a multiple of 64); its scales are the plane's
// own groups. The next slice's global loads are in flight in registers
// while the eight warps (2 x 4, each 64 x 32 outputs) run the mma. Row
// tiles are the fastest grid axis, so the blocks that share a weight tile
// run together and read it from L2 after the first. A one-block-per-row
// pre-pass (prep_kernel) writes the row's inverse RMS (with ln) and its
// group sums xg, each in a fixed order. At a group's first k-slice the
// block stages the tile's xg and (zero + 8) * scale, and every accumulator
// takes the group's rank-1 correction (fmaf, f32) before the group's
// products, groups in order.
//
// Both: the k order of every output is fixed (the k16 steps in order, the
// warp tile's ldmatrix fragments of a row-major [row][k] activation tile and
// a [col][k] weight tile, the correction first in its group), and no block
// sums another's partials: a row's bits do not depend on how many rows
// share the launch, nor on K7's block height. No floating-point atomics.
// Ragged rows and columns are masked.
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


// K7's pre-pass, one block per row: prep_kernel's inverse RMS (the same
// sums in the same order) and, with ln, the row's normed activations
// bf16((x * inv) * ln), the two products unfused and rounded to nearest, as
// the staging of the bf16 operand rounds them; or (zeros, no ln) its group
// sums xg of x. The main kernel then reads one bf16 matrix and no ln.
struct K7Prep {
  const __nv_bfloat16* x;   // [n, din]
  int din;
  int groups;
  const float* ln;          // null: no norm
  float eps;
  float* inv;               // [n] or null
  __nv_bfloat16* xn;        // [n, din] (ln only)
  float* xg;                // [n, groups] or null
};

__global__ void __launch_bounds__(kThreads) k7_prep_kernel(const K7Prep a) {
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
      if (a.inv) a.inv[blockIdx.x] = rinv;
    }
    __syncthreads();
    const float r = rinv;
    for (int f = 8 * threadIdx.x; f < a.din; f += 8 * kThreads) {
      const uint4 v = *reinterpret_cast<const uint4*>(a.x + base + f);
      const uint32_t* pv = reinterpret_cast<const uint32_t*>(&v);
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x0 = __uint_as_float(pv[i] << 16);
        const float x1 = __uint_as_float(pv[i] & 0xffff0000u);
        o[i] = pack_bf16(__fmul_rn(__fmul_rn(x0, r), a.ln[f + 2 * i]),
                         __fmul_rn(__fmul_rn(x1, r), a.ln[f + 2 * i + 1]));
      }
      *reinterpret_cast<uint4*>(a.xn + base + f) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  if (!a.xg) return;
  const int gs = a.din / a.groups;
  for (int gi = warp; gi < a.groups; gi += kWarps) {
    float s = 0.f;
    for (int f = gi * gs + lane; f < (gi + 1) * gs; f += 32) {
      s = __fadd_rn(s, __bfloat162float(a.x[base + f]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) a.xg[(long long)blockIdx.x * a.groups + gi] = s;
  }
}


// ---------------------------------------------------------------------------
// K7 (int8): the main kernel.

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The code in byte j of u, whose codes are stored with their sign bits
// flipped, as an exact f32: 2^23 + (code + 128) - (2^23 + 128).
__device__ __forceinline__ float code_f32(uint32_t u, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)), 8388736.f);
}

struct K7Args {
  const __nv_bfloat16* x;   // [n, din]: x, or the pre-pass's normed rows
  int n;
  int din;
  const uint8_t* w;         // [din, dout] int8 codes
  int dout;
  int wvec;                 // weight copy width: 16, 4 or 1 bytes
  const void* scales;       // [groups, dout]
  int s_bf16;
  int groups;
  const float* zeros;       // [groups, dout] or null
  const float* xg;          // [n, groups] (zeros only)
  __nv_bfloat16* out;       // [n, dout]
};

// 2 WR row warps of 64 rows, four column warps of 32 columns.
template <int WR>
struct K7Tile {
  static constexpr int BMr = 128 * WR;        // output rows per block
  static constexpr int kThr = 256 * WR;
  static constexpr int S = WR == 1 ? 3 : 4;   // ring stages
  static constexpr int AST = BMr * BK * 2;    // activation bytes a stage
  static constexpr int STAGE = AST + BK * BN; // + the weight bytes
  static constexpr int BSZ = BN * BK;         // bf16 values of one converted tile
  static constexpr int CSN = BMr + BN;        // floats of one group's correction
  static constexpr int SMEM = S * STAGE + 2 * BSZ * 2;
};

// Ring stage s holds step s: the activation rows of k-slice s and the weight
// bytes of slice s + 1. Iteration t runs slice t's mma on its rows and on Bs
// [t % 2], converts slice t + 1's bytes (code * scale -> bf16) into
// Bs[(t + 1) % 2], and issues step t + S - 1's copies; one barrier ends it.
// Rows of the staged activations and of Bs ([col][k]) are 16-byte chunks
// XOR-swizzled by the row's low three bits, so ldmatrix and the conversion's
// stores hit distinct banks; the fragments ldmatrix hands over are those of
// an unswizzled tile.
template <int WR, bool kZeros>
__global__ void __launch_bounds__(256 * WR, kZeros ? 1 : 2 / WR) k7_mma_kernel(const K7Args a) {
  using T = K7Tile<WR>;
  constexpr int BMr = T::BMr, kThr = T::kThr, S = T::S;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const Bs = reinterpret_cast<__nv_bfloat16*>(smem + S * T::STAGE);
  // kZeros: [group parity][the group's xg of the tile's rows, then its
  // columns' zero * scale]
  float* const Cs = reinterpret_cast<float*>(smem + T::SMEM);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * BMr;
  const int col0 = blockIdx.y * BN;
  const int spg = a.din / a.groups / BK;      // slices per group
  const int ns = a.din / BK;

  auto astage = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * T::STAGE); };
  auto wstage = [&](int st) { return smem + st * T::STAGE + T::AST; };

  auto load_a = [&](int t, int st) {
    __nv_bfloat16* d = astage(st);
#pragma unroll
    for (int i = 0; i < BMr * 8 / kThr; ++i) {
      const int e = tid + i * kThr;
      const int r = e >> 3;
      const int c = e & 7;
      const bool ok = row0 + r < a.n;
      const __nv_bfloat16* src = a.x + (long long)(row0 + r) * a.din + t * BK + 8 * c;
      cp_async16(d + r * BK + 8 * (c ^ (r & 7)), ok ? src : a.x, ok ? 16 : 0);
    }
  };
  auto load_w = [&](int t, int st) {
    uint8_t* d0 = wstage(st);
    for (int e = tid; e < BK * (BN / 16); e += kThr) {
      const int r = e >> 3;
      const int c = e & 7;
      uint8_t* d = d0 + r * BN + 16 * c;
      const int col = col0 + 16 * c;
      const int left = a.dout - col;          // bytes of this chunk inside dout
      const uint8_t* src = a.w + (long long)(t * BK + r) * a.dout + col;
      if (a.wvec == 16) {
        cp_async16(d, left > 0 ? src : a.w, left > 0 ? 16 : 0);
      } else if (a.wvec == 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cp_async4(d + 4 * q, left > 4 * q ? src + 4 * q : a.w, left > 4 * q ? 4 : 0);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) d[b] = b < left ? __ldg(src + b) : (uint8_t)0;
      }
    }
  };

  // conversion: threads 0-255, k rows 8 ck .. 8 ck + 7 of a slice, columns
  // bc .. bc + 3 of the tile; a lane's j-th store is column bc + ((j + lane
  // / 2) % 4), so the eight lanes of a store phase hit eight chunk slots
  const bool conv = tid < 256;
  const int ck = warp & 7;
  const int bc = 4 * lane;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};  // the group's scales of those columns, in store order
  float zc[4] = {0.f, 0.f, 0.f, 0.f};  // kZeros, ck == 0: their zero points
  float xgr = 0.f;             // kZeros, tid < BMr: row tid's xg of the group
  auto fetch = [&](int u) {    // slice u's group
    const int gi = u / spg;
    if (conv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + bc + ((j + (lane >> 1)) & 3);
        const bool ok = col < a.dout;
        const long long si = (long long)gi * a.dout + col;
        sc[j] = ok ? load_val(a.scales, a.s_bf16, si) : 0.f;
        if (kZeros) zc[j] = (ok && ck == 0) ? a.zeros[si] : 0.f;
      }
    }
    if (kZeros && tid < BMr) {
      xgr = row0 + tid < a.n ? a.xg[(long long)(row0 + tid) * a.groups + gi] : 0.f;
    }
  };
  auto convert = [&](int u, const uint8_t* wr) {
    if (conv) {
      __nv_bfloat16* bs = Bs + (u & 1) * T::BSZ;
      uint32_t wv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        wv[i] = *reinterpret_cast<const uint32_t*>(wr + (8 * ck + i) * BN + bc) ^ 0x80808080u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = (j + (lane >> 1)) & 3;
        const int col = bc + c;
        uint32_t p[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          p[h] = pack_bf16(__fmul_rn(code_f32(wv[2 * h], c), sc[j]),
                           __fmul_rn(code_f32(wv[2 * h + 1], c), sc[j]));
        }
        *reinterpret_cast<uint4*>(bs + col * BK + 8 * (ck ^ (col & 7))) =
            make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
    if (kZeros && u % spg == 0) {            // a group's first slice
      float* cs = Cs + ((u / spg) & 1) * T::CSN;
      if (tid < BMr) cs[tid] = xgr;
      if (conv && ck == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs[BMr + bc + ((j + (lane >> 1)) & 3)] = __fmul_rn(__fadd_rn(zc[j], 0.f), sc[j]);
        }
      }
    }
  };

  // mma: warp tile 64 rows x 32 columns; ldmatrix rows: A wm + lane % 16 at
  // k chunk lane / 16, B columns wn + lane % 8 + 8 (lane / 16) at k chunk
  // (lane / 8) % 2; each address's row ends in lane % 8, its swizzle
  const int wm = (warp >> 2) * 64;
  const int wn = (warp & 3) * 32;
  const int a_off = (wm + (lane & 15)) * BK;
  const int a_ch = lane >> 4;
  const int b_off = (wn + (lane & 7) + ((lane >> 4) << 3)) * BK;
  const int b_ch = (lane >> 3) & 1;
  const int sw = lane & 7;
  const int g = lane >> 2;
  const int tg = lane & 3;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

  load_w(0, S - 1);            // slice 0's bytes, in the stage step S - 1 takes
  cp_async_commit();
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (st < ns) {
      load_a(st, st);
      if (st + 1 < ns) load_w(st + 1, st);
    }
    cp_async_commit();
  }
  fetch(0);
  cp_async_wait<S - 1>();
  __syncthreads();
  convert(0, wstage(S - 1));
  if (ns > 1 && spg == 1) fetch(1);
  cp_async_wait<S - 2>();
  __syncthreads();

  for (int t = 0; t < ns; ++t) {
    const int st = t % S;
    {
      const int tn = t + S - 1;
      if (tn < ns) {
        load_a(tn, tn % S);
        if (tn + 1 < ns) load_w(tn + 1, tn % S);
      }
      cp_async_commit();
    }
    if (t + 1 < ns) convert(t + 1, wstage(st));
    if (t + 2 < ns && (t + 2) % spg == 0) fetch(t + 2);
    if (kZeros && t % spg == 0) {
      // the group's correction, as a rank-1 update of the accumulators
      // before its products: acc -= xg[row] * zero[col] * scale[col]
      const float* cs = Cs + ((t / spg) & 1) * T::CSN;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float xr = cs[wm + mi * 16 + g + 8 * h];
#pragma unroll
          for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              acc[mi][ni][2 * h + e] =
                  fmaf(-xr, cs[BMr + wn + ni * 8 + tg * 2 + e], acc[mi][ni][2 * h + e]);
            }
        }
    }
    const __nv_bfloat16* as = astage(st);
    const __nv_bfloat16* bs = Bs + (t & 1) * T::BSZ;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t af[4][4], bf[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldmatrix_x4(af[mi], as + a_off + mi * 16 * BK + 8 * ((2 * kk + a_ch) ^ sw));
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        ldmatrix_x4(bf[nj], bs + b_off + nj * 16 * BK + 8 * ((2 * kk + b_ch) ^ sw));
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_bf16(acc[mi][ni], af[mi], bf[ni >> 1][(ni & 1) * 2],
                   bf[ni >> 1][(ni & 1) * 2 + 1]);
        }
    }
    cp_async_wait<S - 2>();
    __syncthreads();
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
        __nv_bfloat16* o = a.out + (long long)rr * a.dout + c;
        if (c + 1 < a.dout && (a.dout & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) =
              __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (c + e < a.dout) o[e] = __float2bfloat16_rn(acc[mi][ni][2 * h + e]);
          }
        }
      }
    }
  }
}

template <int WR, bool kZeros>
int k7_launch(const K7Args& a, cudaStream_t stream) {
  using T = K7Tile<WR>;
  constexpr int smem = T::SMEM + (kZeros ? 2 * T::CSN * 4 : 0);
  static bool configured = false;        // the opt-in above 48 KB, once
  if (!configured) {
    int err = (int)cudaFuncSetAttribute(k7_mma_kernel<WR, kZeros>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err) {
      err = (int)cudaFuncSetAttribute(k7_mma_kernel<WR, kZeros>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err) return err;
    configured = true;
  }
  const dim3 grid((a.n + T::BMr - 1) / T::BMr, (a.dout + BN - 1) / BN);
  k7_mma_kernel<WR, kZeros><<<grid, T::kThr, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (!packed) return kErrShape;                  // int8 (K7) runs hsd_k7
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
  mma_kernel<true, true><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// K7's pre-pass alone (its check on the card): inv [n] (ln, may be null),
// xn [n, din] (ln) and xg [n, groups] (may be null). Returns 0, a CUDA error
// code, or kErrShape.
extern "C" int hsd_k7_stage(const void* x, int n, int din, int groups,
                            const void* ln, float eps, void* inv, void* xn,
                            void* xg, void* stream) {
  if (n <= 0 || din <= 0 || din % BK || groups <= 0 || din % groups) return kErrShape;
  if (ln ? !xn : !xg) return kErrShape;
  K7Prep p;
  p.x = reinterpret_cast<const __nv_bfloat16*>(x); p.din = din; p.groups = groups;
  p.ln = reinterpret_cast<const float*>(ln); p.eps = eps;
  p.inv = reinterpret_cast<float*>(inv);
  p.xn = reinterpret_cast<__nv_bfloat16*>(xn);
  p.xg = reinterpret_cast<float*>(xg);
  k7_prep_kernel<<<n, kThreads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// K7: y[n, dout] = bf16(x or (x * inv) * ln) @ bf16(code * scale), f32
// accumulation, less sum_g xg * zero * scale, rounded to bf16; x and y bf16,
// int8 codes. ln and zeros may be null, not both given; with ln, xn is an
// [n, din] bf16 workspace, with zeros xg an [n, groups] f32 one. bm: output
// rows per block, 128 or (without zeros) 256 (ops/gptq_cuda.k7_block_rows).
// Returns 0, a CUDA error code, or kErrShape.
extern "C" int hsd_k7(const void* x, int n, int din, const void* w, int dout,
                      const void* scales, int s_bf16, const void* zeros,
                      int groups, const void* ln, float eps, void* xn, void* xg,
                      int bm, void* out, void* stream) {
  if (n <= 0 || din <= 0 || dout <= 0 || groups <= 0 || din % groups) return kErrShape;
  if ((din / groups) % BK) return kErrShape;
  if (ln && (!xn || zeros)) return kErrShape;
  if (zeros && !xg) return kErrShape;
  if (bm != 128 && (bm != 256 || zeros)) return kErrShape;
  const long long col_blocks = (dout + BN - 1) / BN;
  if (col_blocks > 65535) return kErrShape;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (ln || zeros) {
    const int err = hsd_k7_stage(x, n, din, groups, ln, eps, nullptr, xn,
                                 zeros ? xg : nullptr, stream);
    if (err) return err;
  }
  K7Args a;
  a.x = reinterpret_cast<const __nv_bfloat16*>(ln ? xn : x); a.n = n; a.din = din;
  a.w = reinterpret_cast<const uint8_t*>(w); a.dout = dout;
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  a.wvec = (dout % 16 == 0 && wp % 16 == 0) ? 16 : (dout % 4 == 0 && wp % 4 == 0) ? 4 : 1;
  a.scales = scales; a.s_bf16 = s_bf16; a.groups = groups;
  a.zeros = reinterpret_cast<const float*>(zeros);
  a.xg = reinterpret_cast<const float*>(xg);
  a.out = reinterpret_cast<__nv_bfloat16*>(out);
  if (zeros) return k7_launch<1, true>(a, s);
  return bm == 256 ? k7_launch<2, false>(a, s) : k7_launch<1, false>(a, s);
}

extern "C" const char* hsd_mma_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the GPTQ tensor-core kernel";
  return cudaGetErrorString((cudaError_t)code);
}
