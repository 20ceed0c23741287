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
// One design for both (k7_prep_kernel + k7_mma_kernel). A per-row pre-pass
// writes what every column block would otherwise redo: with ln, the row's
// inverse RMS and its normed activations bf16((x * inv) * ln) as an [n, din]
// matrix; with a correction (zero points, or packed int4, whose unsigned
// nibbles always need one), its group sums xg of the unrounded f32 (normed)
// rows. The main kernel then reads one bf16 matrix. A block owns 128 rows x
// 128 columns (eight warps, two blocks an SM) or, where a grid of 256-row
// blocks keeps half the SMs busy, 256 rows (sixteen warps, one block an SM),
// so each weight slice is converted for more rows; the height comes from the
// shape and the card only (ops/gptq_cuda.k7_block_rows). With a correction a
// block owns 128 rows and runs alone on its SM: the correction's registers
// would spill at two. It walks din in k-slices of 64 through a cp.async ring
// of three stages (four for 256-row blocks and K7i4): stage s holds slice
// s's activation rows and slice s + 1's raw weight bytes (16-, 4- or 1-byte
// copies, the ragged columns zero-filled). In one barrier interval the
// warps run slice t's mma.sync m16n8k16 bf16 -> f32 on its rows and on the
// converted tile Bs[t % 2] ([col][k]), convert slice t + 1's bytes (code ->
// exact f32 -> * scale -> bf16) into Bs[(t + 1) % 2], and issue the copies
// of the step S - 1 ahead; the
// scales, zero points and xg of a group are fetched one slice ahead into
// registers. At a group's first slice the accumulators take its rank-1
// correction (acc -= xg * (zero + off) * scale, fmaf) before its products,
// from a correction tile double-buffered by group parity.
//
// Packed int4 (K7i4) differs in the bytes and in the block's warps. With
// the split-half layout input row k < din/2 is the low nibble of byte row k
// and row k >= din/2 the high nibble of byte row k - din/2; a 64-wide slice
// never straddles din/2 (din/2 is a whole number of groups, each a multiple
// of 64 rows), so slice t stages 64 byte rows of one plane, and the
// conversion takes that plane's nibbles (>> 4 for the high one,
// & 0x0f0f0f0f) as exact f32 of the stored unsigned value. Its scales are
// the input rows' own groups. It always has a correction, and its 128-row
// block gives the conversion warps of their own (CW): in one barrier
// interval those warps convert slice t + 1 while eight others run slice t's
// mma, so the interval costs the longer of the two, not their sum as when
// every warp does both; one block an SM, no spill.
//
// The k order of every output is fixed (the k16 steps in order, the warp
// tile's ldmatrix fragments of a row-major [row][k] activation tile and a
// [col][k] weight tile, the correction first in its group), and no block
// sums another's partials: a row's bits do not depend on how many rows
// share the launch, nor on the block height. No floating-point atomics.
// Ragged rows and columns are masked.
//
// Layouts (ops/linear.py of the port): w [din, dout] int8 codes, or
// [din/2, dout] uint8 split-half nibbles; scales [groups, dout] (bf16 or
// f32); zeros [groups, dout] f32 or null; group g covers input rows
// [g*gs, (g+1)*gs), gs a multiple of 64. x [n, din] bf16 or f32, 16-byte
// aligned; ln [din] f32; the output [n, dout] in x's type. f32 rows, as the
// Pallas mode casts them inside its kernel (gptq_pallas.py:72-76, 102-110),
// round to bf16 in the pre-pass (after the norm, with ln), which then also
// runs without ln; the group sums stay those of the unrounded f32 rows, and
// the f32 output takes the accumulators unrounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // input features per k-slice
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kErrShape = 100000;       // unsupported shape

__device__ __forceinline__ float load_val(const void* p, int bf16, long long i) {
  if (bf16) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

// two f32 values rounded to bf16 and packed, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// The pre-pass, one block per row: with ln, the row's inverse RMS (lanes
// strided over the features, a butterfly over the warp, the warps in order)
// and its normed activations bf16((x * inv) * ln), the two products unfused
// and rounded to nearest; without ln, for f32 rows, the rounded rows bf16(x)
// (the main kernel reads bf16 operands only); with a correction, its group
// sums xg of the f32 values before that rounding, (x * inv) * ln with ln,
// else x (one warp a group: lanes strided by 32, then the butterfly). The
// main kernel then reads one bf16 matrix and no ln. x is bf16 or f32
// (kF32): a bf16 value widens to f32 exactly, so the arithmetic after the
// load is the same for both.
struct K7Prep {
  const void* x;            // [n, din] bf16, or f32 (kF32)
  int din;
  int groups;
  const float* ln;          // null: no norm
  float eps;
  float* inv;               // [n] or null
  __nv_bfloat16* xn;        // [n, din] (ln, or an f32 x)
  float* xg;                // [n, groups] or null
};

template <bool kF32>
__device__ __forceinline__ float load_x(const void* x, long long i) {
  if (kF32) return reinterpret_cast<const float*>(x)[i];
  return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(x)[i]);
}

// Eight consecutive values of x from element i (16-byte aligned) as f32.
template <bool kF32>
__device__ __forceinline__ void load_x8(const void* x, long long i, float (&v)[8]) {
  if (kF32) {
    const float4* p = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(x) + i);
    const float4 a = p[0], b = p[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    const uint4 u = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(x) + i);
    const uint32_t* pu = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(pu[j] << 16);
      v[2 * j + 1] = __uint_as_float(pu[j] & 0xffff0000u);
    }
  }
}

template <bool kF32>
__global__ void __launch_bounds__(kThreads) k7_prep_kernel(const K7Prep a) {
  __shared__ float part[kWarps];
  __shared__ float rinv;
  const long long base = (long long)blockIdx.x * a.din;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (a.ln) {
    float s = 0.f;
    for (int f = threadIdx.x; f < a.din; f += kThreads) {
      const float v = load_x<kF32>(a.x, base + f);
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
  }
  if (a.xn) {
    const float r = a.ln ? rinv : 1.f;
    for (int f = 8 * threadIdx.x; f < a.din; f += 8 * kThreads) {
      float v[8];
      load_x8<kF32>(a.x, base + f, v);
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        o[i] = a.ln ? pack_bf16(__fmul_rn(__fmul_rn(v[2 * i], r), a.ln[f + 2 * i]),
                                __fmul_rn(__fmul_rn(v[2 * i + 1], r), a.ln[f + 2 * i + 1]))
                    : pack_bf16(v[2 * i], v[2 * i + 1]);
      }
      *reinterpret_cast<uint4*>(a.xn + base + f) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  if (!a.xg) return;
  const int gs = a.din / a.groups;
  for (int gi = warp; gi < a.groups; gi += kWarps) {
    float s = 0.f;
    for (int f = gi * gs + lane; f < (gi + 1) * gs; f += 32) {
      float v = load_x<kF32>(a.x, base + f);
      if (a.ln) v = __fmul_rn(__fmul_rn(v, rinv), a.ln[f]);
      s = __fadd_rn(s, v);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) a.xg[(long long)blockIdx.x * a.groups + gi] = s;
  }
}


// ---------------------------------------------------------------------------
// The main kernel.

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

// The code in byte j of u as an exact f32: 2^23 + byte - (2^23 + bias).
// int8 codes are stored with their sign bits flipped (bias 128), packed
// nibbles as the unsigned stored value (bias 0).
template <bool kPacked>
__device__ __forceinline__ float code_f32(uint32_t u, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)),
                   kPacked ? 8388608.f : 8388736.f);
}

struct K7Args {
  const __nv_bfloat16* x;   // [n, din]: x, or the pre-pass's normed rows
  int n;
  int din;
  const uint8_t* w;         // [din, dout] int8 codes or [din/2, dout] nibbles
  int dout;
  int wvec;                 // weight copy width: 16, 4 or 1 bytes
  const void* scales;       // [groups, dout]
  int s_bf16;
  int groups;
  const float* zeros;       // [groups, dout] or null
  const float* xg;          // [n, groups] (a correction only)
  void* out;                // [n, dout] bf16, or f32 (out_f32)
  int out_f32;
};

// BM rows a block: warp tiles of 64 rows x 32 columns, BM / 64 row warps by
// four column warps, after CW warps of their own for the conversion (none:
// the first eight warps convert and every warp runs mma).
template <int BM, int CW>
struct K7Tile {
  static constexpr int BMr = BM;              // output rows per block
  static constexpr int kThr = (CW + BM / 64 * 4) * 32;
  static constexpr int S = BM == 256 || CW ? 4 : 3;  // ring stages
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
// an unswizzled tile. The block height leaves each output's mma steps and
// their order as they are. With CW conversion warps the interval's
// conversion and mma run on different warps, side by side. kZp: zero
// points; kPacked: split-half nibbles, slice t's bytes the rows t * BK
// (below din/2: the low plane) or t * BK - din/2 (the high plane). Either
// takes a rank-1 correction (kCorr), packed int4's with an offset of 8, and
// then a block runs alone on its SM (its registers); else two 128-row
// blocks share one.
template <int BM, int CW, bool kZp, bool kPacked>
__global__ void __launch_bounds__(K7Tile<BM, CW>::kThr, kZp || kPacked ? 1 : 256 / BM)
    k7_mma_kernel(const K7Args a) {
  using T = K7Tile<BM, CW>;
  constexpr bool kCorr = kZp || kPacked;
  constexpr int BMr = T::BMr, kThr = T::kThr, S = T::S;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const Bs = reinterpret_cast<__nv_bfloat16*>(smem + S * T::STAGE);
  // kCorr: [group parity][the group's xg of the tile's rows, then its
  // columns' (zero + offset) * scale]
  float* const Cs = reinterpret_cast<float*>(smem + T::SMEM);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row0 = blockIdx.x * BMr;
  const int col0 = blockIdx.y * BN;
  const int spg = a.din / a.groups / BK;      // slices per group
  const int ns = a.din / BK;
  const int half = a.din / 2;                 // kPacked: the high plane's first row

  auto astage = [&](int st) { return reinterpret_cast<__nv_bfloat16*>(smem + st * T::STAGE); };
  auto wstage = [&](int st) { return smem + st * T::STAGE + T::AST; };

  auto load_a = [&](int t, int st) {
    __nv_bfloat16* d = astage(st);
#pragma unroll
    for (int i = 0; i < (BMr * 8 + kThr - 1) / kThr; ++i) {
      const int e = tid + i * kThr;
      if (CW && e >= BMr * 8) break;
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
      const int k0 = kPacked && t * BK >= half ? t * BK - half : t * BK;
      const uint8_t* src = a.w + (long long)(k0 + r) * a.dout + col;
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

  // conversion: threads 0-255 (CW: warps 0 .. CW - 1), k rows 8 ck .. 8 ck
  // + 7 of a slice (CW: those of ck, ck + CW, ...), columns bc .. bc + 3 of
  // the tile; a lane's j-th store is column bc + ((j + lane / 2) % 4), so the
  // eight lanes of a store phase hit eight chunk slots
  const bool conv = CW ? warp < CW : tid < 256;
  const int ck = warp & 7;
  const int bc = 4 * lane;
  float sc[4] = {0.f, 0.f, 0.f, 0.f};  // the group's scales of those columns, in store order
  float zc[4] = {0.f, 0.f, 0.f, 0.f};  // kZp, ck == 0: their zero points
  float xgr = 0.f;             // kCorr, tid < BMr: row tid's xg of the group
  auto fetch = [&](int u) {    // slice u's group
    const int gi = u / spg;
    if (conv) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + bc + ((j + (lane >> 1)) & 3);
        const bool ok = col < a.dout;
        const long long si = (long long)gi * a.dout + col;
        sc[j] = ok ? load_val(a.scales, a.s_bf16, si) : 0.f;
        if (kZp) zc[j] = (ok && ck == 0) ? a.zeros[si] : 0.f;
      }
    }
    if (kCorr && tid < BMr) {
      xgr = row0 + tid < a.n ? a.xg[(long long)(row0 + tid) * a.groups + gi] : 0.f;
    }
  };
  auto convert = [&](int u, const uint8_t* wr) {
    if (conv) {
      __nv_bfloat16* bs = Bs + (u & 1) * T::BSZ;
      const int shift = kPacked && u * BK >= half ? 4 : 0;   // the slice's nibble plane
#pragma unroll
      for (int q = 0; q < (CW ? 8 / CW : 1); ++q) {
        const int kc = ck + q * CW;          // this pass's chunk of 8 k rows
        uint32_t wv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const uint32_t b = *reinterpret_cast<const uint32_t*>(wr + (8 * kc + i) * BN + bc);
          wv[i] = kPacked ? (b >> shift) & 0x0f0f0f0fu : b ^ 0x80808080u;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = (j + (lane >> 1)) & 3;
          const int col = bc + c;
          uint32_t p[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            p[h] = pack_bf16(__fmul_rn(code_f32<kPacked>(wv[2 * h], c), sc[j]),
                             __fmul_rn(code_f32<kPacked>(wv[2 * h + 1], c), sc[j]));
          }
          *reinterpret_cast<uint4*>(bs + col * BK + 8 * (kc ^ (col & 7))) =
              make_uint4(p[0], p[1], p[2], p[3]);
        }
      }
    }
    if (kCorr && u % spg == 0) {             // a group's first slice
      float* cs = Cs + ((u / spg) & 1) * T::CSN;
      if (tid < BMr) cs[tid] = xgr;
      if (conv && ck == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          cs[BMr + bc + ((j + (lane >> 1)) & 3)] =
              __fmul_rn(__fadd_rn(zc[j], kPacked ? 8.f : 0.f), sc[j]);
        }
      }
    }
  };

  // mma (warps CW ..): warp tile 64 rows x 32 columns; ldmatrix rows: A wm
  // + lane % 16 at k chunk lane / 16, B columns wn + lane % 8 + 8 (lane / 16)
  // at k chunk (lane / 8) % 2; each address's row ends in lane % 8, its
  // swizzle
  const bool mw = CW == 0 || warp >= CW;
  const int wm = ((warp - CW) >> 2) * 64;
  const int wn = ((warp - CW) & 3) * 32;
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
    if (mw && kCorr && t % spg == 0) {
      // the group's correction, as a rank-1 update of the accumulators
      // before its products: acc -= xg[row] * (zero + offset)[col] * scale[col]
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
      if (!mw) break;
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

  if (!mw) return;
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
        const long long oi = (long long)rr * a.dout + c;
        if (a.out_f32) {
          float* o = reinterpret_cast<float*>(a.out) + oi;
          if (c + 1 < a.dout && (a.dout & 1) == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          } else {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (c + e < a.dout) o[e] = acc[mi][ni][2 * h + e];
            }
          }
          continue;
        }
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(a.out) + oi;
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

template <int BM, int CW, bool kZp, bool kPacked>
int k7_launch(const K7Args& a, cudaStream_t stream) {
  using T = K7Tile<BM, CW>;
  constexpr bool kCorr = kZp || kPacked;
  constexpr int smem = T::SMEM + (kCorr ? 2 * T::CSN * 4 : 0);
  static bool configured = false;        // the opt-in above 48 KB, once
  if (!configured) {
    int err = (int)cudaFuncSetAttribute(k7_mma_kernel<BM, CW, kZp, kPacked>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err) {
      err = (int)cudaFuncSetAttribute(k7_mma_kernel<BM, CW, kZp, kPacked>,
                                      cudaFuncAttributePreferredSharedMemoryCarveout,
                                      (int)cudaSharedmemCarveoutMaxShared);
    }
    if (err) return err;
    configured = true;
  }
  const dim3 grid((a.n + T::BMr - 1) / T::BMr, (a.dout + BN - 1) / BN);
  k7_mma_kernel<BM, CW, kZp, kPacked><<<grid, T::kThr, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// The pre-pass alone (its check on the card): x [n, din] bf16 or (x_f32)
// f32; inv [n] (ln, may be null), xn [n, din] (ln, or an f32 x: its bf16
// operand) and xg [n, groups] (may be null; with ln, the sums of the normed
// rows before rounding). Returns 0, a CUDA error code, or kErrShape.
extern "C" int hsd_k7_stage(const void* x, int x_f32, int n, int din, int groups,
                            const void* ln, float eps, void* inv, void* xn,
                            void* xg, void* stream) {
  if (n <= 0 || din <= 0 || din % BK || groups <= 0 || din % groups) return kErrShape;
  if ((ln || x_f32) ? !xn : !xg) return kErrShape;
  K7Prep p;
  p.x = x; p.din = din; p.groups = groups;
  p.ln = reinterpret_cast<const float*>(ln); p.eps = eps;
  p.inv = reinterpret_cast<float*>(inv);
  p.xn = reinterpret_cast<__nv_bfloat16*>(xn);
  p.xg = reinterpret_cast<float*>(xg);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_f32) {
    k7_prep_kernel<true><<<n, kThreads, 0, s>>>(p);
  } else {
    k7_prep_kernel<false><<<n, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

// K7 and K7i4: y[n, dout] = bf16(x or (x * inv) * ln) @ bf16(code * scale),
// f32 accumulation, less sum_g xg * (zero + off) * scale, rounded to y's
// type; x and y bf16, or (x_f32) both f32, the product then unrounded.
// packed: w holds split-half nibbles (off = 8, an even group count), else
// int8 codes (off = 0). ln and zeros may be null, not both given; with ln,
// or an f32 x, xn is an [n, din] bf16 workspace (the pre-pass writes the
// bf16 operand there); packed or with zeros, xg an [n, groups] f32 one. bm:
// output rows per block, 128 or (no correction) 256
// (ops/gptq_cuda.k7_block_rows). Returns 0, a CUDA error code, or
// kErrShape.
extern "C" int hsd_k7(const void* x, int x_f32, int n, int din, const void* w, int packed,
                      int dout, const void* scales, int s_bf16, const void* zeros,
                      int groups, const void* ln, float eps, void* xn, void* xg,
                      int bm, void* out, void* stream) {
  if (n <= 0 || din <= 0 || dout <= 0 || groups <= 0 || din % groups) return kErrShape;
  if ((din / groups) % BK) return kErrShape;
  if (packed && groups % 2) return kErrShape;      // the planes span whole groups
  const bool corr = packed || zeros;
  const bool staged = ln || x_f32;       // the kernel reads the pre-pass's xn
  if (ln && zeros) return kErrShape;
  if (staged && !xn) return kErrShape;
  if (corr && !xg) return kErrShape;
  if (bm != 128 && (bm != 256 || corr)) return kErrShape;
  const long long col_blocks = (dout + BN - 1) / BN;
  if (col_blocks > 65535) return kErrShape;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (staged || corr) {
    const int err = hsd_k7_stage(x, x_f32, n, din, groups, ln, eps, nullptr,
                                 staged ? xn : nullptr, corr ? xg : nullptr, stream);
    if (err) return err;
  }
  K7Args a;
  a.x = reinterpret_cast<const __nv_bfloat16*>(staged ? xn : x); a.n = n; a.din = din;
  a.w = reinterpret_cast<const uint8_t*>(w); a.dout = dout;
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  a.wvec = (dout % 16 == 0 && wp % 16 == 0) ? 16 : (dout % 4 == 0 && wp % 4 == 0) ? 4 : 1;
  a.scales = scales; a.s_bf16 = s_bf16; a.groups = groups;
  a.zeros = reinterpret_cast<const float*>(zeros);
  a.xg = reinterpret_cast<const float*>(xg);
  a.out = out;
  a.out_f32 = x_f32;
  if (packed) return zeros ? k7_launch<128, 4, true, true>(a, s) : k7_launch<128, 4, false, true>(a, s);
  if (zeros) return k7_launch<128, 0, true, false>(a, s);
  return bm == 256 ? k7_launch<256, 0, false, false>(a, s) : k7_launch<128, 0, false, false>(a, s);
}

extern "C" const char* hsd_mma_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the GPTQ tensor-core kernel";
  return cudaGetErrorString((cudaError_t)code);
}
