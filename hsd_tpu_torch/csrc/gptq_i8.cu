// K4 and K5 (int8), K1 and K3 (packed int4), and the fused int4 layer tail
// K2 and MLP K6: GPTQ dequantize-and-matmul on the tensor cores for Hopper
// (sm_90a), with f32-exact operands.
//
// Hand-written counterpart of the f32-operand (mxu_bf16=False) Pallas kernels
// in hsd_tpu/ops/gptq_pallas.py:
//   K4  _kernel          int8: x @ (code * scale), with the rank-1 zero-point
//                        correction gptq_matmul subtracts outside it (:500-526)
//   K5  _kernel_ln       int8: rmsnorm(x, ln) @ (code * scale), symmetric; the
//                        normed activations x * rsqrt(mean(x^2) + eps) * ln
//                        stay f32 (:103-110)
//   K3  _kernel_int4     packed int4: x @ (nibble * scale), with the rank-1
//                        correction of the -8 and the zero points (:500-526)
//   K1  _kernel_int4_ln  packed int4: rmsnorm(x, ln) @ (nibble * scale) less
//                        8 * scale times the normed group sums, symmetric
//                        (:196-219)
//   K2  _kernel_attn_mlp_int4  packed int4, the layer tail: x' = resid +
//                        att @ deq(Wo) kept f32, [g | u] = rmsnorm(x', ln) @
//                        deq(Wgu), out = x' + (silu(g) * u) @ deq(Wdown)
//                        (:617-725)
//   K6  _kernel_mlp_int4 the same MLP on x, without the residual (:530-614)
// K2 and K6 are three (two) products of the int4 kernel below, each writing
// f32 partials that an epilogue pass sums in split order and finishes: the
// residual added in f32 after the whole sum (x' and the output, as JAX adds
// `res + acc` and `xn + acc` after the dot), or the SwiGLU of the gate and
// up columns. wgu takes K1's pre-pass on x', wdown K3's in-kernel split of
// the f32 ff. A Hopper grid has no ordered steps to carry x' and ff from
// phase to phase as the Pallas grid does, so they pass through one
// workspace (about 10 MB at 32 rows of a 14B layer, within the 50 MB L2);
// one persistent launch for the whole tail is later work.
//
// Arithmetic. The JAX kernels multiply f32 activations by the f32 weight
// code * scale below 129 rows, so this kernel must not round an operand to
// bf16 as K7 does. It splits every f32 activation into three bf16 planes,
//   hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid),
// which sum to x exactly (each residual is exact in f32 and has at most 16,
// then 8, significant bits; for |x| above about 2^-110, where lo stays
// above bf16's subnormal spacing of 2^-133). A bf16 activation is its own
// hi plane, and its other planes are zero, so it runs one plane. int8 codes
// and the stored int4 nibbles (0..15) are exact in bf16.
// So every plane x code product on the tensor cores (mma.sync m16n8k16 bf16
// -> f32) is exact, and the only rounding is the f32 accumulation. The codes
// of one quantization group accumulate alone (acc); at the group's end the
// offset enters as the rank-1 term acc - c * xg, xg the row's sum of the
// group's activations (the unrounded x, taken on the tensor cores as the
// planes times a column of ones; K1 takes it from its pre-pass, which saves
// a third of its mma), c the zero point (int8) or 8 + zero (int4:
// the nibbles are stored as code + 8; zero is 0 for a symmetric weight),
// and the group joins the output with out = fmaf(scale, acc, out), groups
// in order. The zeros are non-integer f32 (ops/linear.quantize), so code -
// zero is never staged in bf16, and JAX multiplies by the stored nibble
// (gptq_pallas.py:155-160, 196-201), so the -8 is not staged either.
//
// Bound on the card: at the 1-row decode calls the weight stream (the
// Llama-3.1-8B head, 4096 x 128256: 525 MB of int8, ~0.16 ms at 3.35 TB/s);
// at the 60-128-row prefill, verify and EAGLE-3 beam calls the operations
// (wgu 4096 x 28672 at 60 rows: 14 GFLOP x 3 planes of bf16 mma, ~0.045 ms
// at 989 TFLOP/s, beside 0.035 ms of int8 weight bytes). The design reads
// the weight once per call: a block owns 128 output columns for every row of
// the call up to 128 rows (int8; above that, which only direct calls reach,
// rows tile in such blocks), so the weight never re-streams per few rows,
// and the products run on the tensor cores instead of f32 FMAs. int4 keeps two runs of accumulators, which
// leave too few registers for wide row tiles: its blocks own up to 32 rows,
// two to an SM, and a column block's row blocks launch side by side, so
// they read its weight from device memory once and share it through L2 (at
// 33-64 rows this measured 15-20% faster than 64-row blocks of 16 warps, one
// to an SM).
//
// Layout of the mma. The weight is the A operand (16 output columns x 16
// input features) and the activation rows the B operand (16 features x 8
// rows), so a 1-8-row call wastes at most 7/8 of an mma while the bytes
// bound it. A k16 step's 16 features are assigned to the mma's k slots in a
// permuted order that both operands share (slots 2t, 2t+1, 2t+8, 2t+9 of
// lane quad t hold features 4t..4t+3), and a lane's two M slots are
// neighbouring columns. Then a lane's A fragments for two 16-column tiles
// come from four 32-bit shared-memory words (4 weight rows x 4 columns of
// bytes), and its B fragment is one 8-byte read of 4 consecutive features of
// one row. int8 converts to bf16 with integer ops and one f32 add per code:
// (0x4B000000 | (code ^ 0x80)) as f32 is 2^23 + code + 128, less 2^23 + 128
// the exact code, whose upper 16 bits are its bf16. Packed int4 is
// split-half: byte row r holds feature r in its low nibble and feature
// r + din/2 in its high nibble, so the same four words give 4 low and 4
// high features, which belong to two k16 steps: one over x's first half,
// one over its second. A nibble pair converts as the bf16 bits 0x4300 | n,
// which are 128 + n, less 128 in one bf16x2 subtraction (exact).
//
// Pipeline. Each k-slice of 64 weight rows is staged with cp.async, four
// slices in flight (three where a stage exceeds 24 KB, so that two blocks of
// 33-64 rows fit an SM): the weight's 64 x 128 bytes and the activation
// planes' rows, [run][plane][row][feature] bf16 (int8: one run of 64
// features; int4: the two runs [r0, r0 + 64) and [din/2 + r0, din/2 + r0 +
// 64) that the slice's nibbles multiply), both in 16-byte chunks whose
// position in a row is XOR-swizzled so that the fragment reads hit distinct
// banks. A packed group spans a multiple of 64 byte rows in each nibble
// plane, so a slice never straddles one; its low run is in group
// r0 / gs and its high run in group G/2 + r0 / gs, whose accumulators run
// side by side and join the output at their common end, low then high. The
// planes are ready in device memory: a bf16 x is its own plane, and the
// norm's pre-pass (K5, K1) writes the three planes of the normed rows once
// (rather than every column block norming and splitting them again). Only
// f32 x without a norm (K4, K3) splits in the kernel (a pre-pass would add
// a launch), the next slice's x in registers while the current one
// computes. One barrier a slice (two with the in-kernel split). Eight warps
// (four column warps x two row warps) own 32 columns x 32 rows each at
// 33-64 int8 rows; four warps at up to 32 rows; sixteen at up to 128. For
// int4 a warp owns at most 16 rows: four warps up to 16 rows, eight up to
// 32.
//
// Determinism. Narrow outputs split the input dimension across blocks
// (blockIdx.z), with the split count from the weight's shape and the card
// only (ops/gptq_cuda.splits_for); each split writes an f32 partial and a
// second kernel sums them in split order. Each output accumulates its k16
// steps in order, the planes in order within a step, groups in order, and
// nothing of that depends on the row count or on the rows beside it: a row
// gives the same bits at 1, 17, 64 and 128 rows. No floating-point atomics.
// The norm's pre-pass sums each row's squares in a fixed order (lanes, then
// warps).
//
// Layouts (ops/linear.py of the port): w [din, dout] int8 codes, or [din/2,
// dout] packed int4 (uint8, split-half, nibbles stored as code + 8); scales
// [groups, dout] (bf16 or f32); zeros [groups, dout] f32 or null; group g
// covers input rows [g*gs, (g+1)*gs), gs a multiple of 128 (int8), or of 64
// with an even group count (int4); x [n, din] bf16 or f32, 16-byte aligned;
// ln [din] f32; the output [n, dout] bf16 or f32. Any dout: 16-byte copies
// where rows are 16-byte aligned, else 4-byte or byte copies, the ragged
// columns masked.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                 // output columns per block
constexpr int BK = 64;                  // weight rows per k-slice
constexpr int kTileRows = 128;          // the split unit (splits_for)
constexpr int kMaxRows = 128;           // rows per block at most
constexpr int kMaxRowsI4 = 32;          // int4: rows per block at most
constexpr uint32_t kOnes = 0x3F803F80u; // two bf16 1.0
constexpr int kErrShape = 100000;       // unsupported shape

struct Args {
  const void* x;
  int x_bf16;
  int n;                // activation rows
  int din;
  const int8_t* w;       // int8 codes, or packed int4 bytes
  int dout;
  const void* scales;
  int s_bf16;
  const float* zeros;   // null: symmetric
  int groups;
  const float* ln;      // null: no norm
  float eps;
  __nv_bfloat16* xp;    // the planes [P][n][din]: bf16 x itself, or K5's pre-pass
  void* out;            // [n, dout]
  int o_bf16;
  int splits;           // input-dimension splits (blockIdx.z)
  float* ws;            // [splits, n, dout] f32 partials when splits > 1
  int wvec;             // weight copy width: 16, 4 or 1 bytes
};

// K1's group sums: [n][groups] f32 after the three [n][din] planes of a.xp.
__device__ __forceinline__ float* group_sums(const Args& a) {
  return reinterpret_cast<float*>(a.xp + 3LL * a.n * a.din);
}

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The code in byte j of u (codes stored with their sign bit flipped) as an
// exact f32: 2^23 + (code + 128) - (2^23 + 128).
__device__ __forceinline__ uint32_t code_f32(uint32_t u, int j) {
  return __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j))
                         - 8388736.f);
}

// Two exact f32 codes as a bf16 pair (their upper halves), a in the low half.
__device__ __forceinline__ uint32_t pack_hi(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x7632);
}

// The planes of v after its hi plane bf16(v): mid = v - hi, lo = mid -
// bf16(mid), both exact in f32; bf16(mid) and bf16(lo) are the planes.
__device__ __forceinline__ void split3(float v, float& mid, float& lo) {
  mid = __fsub_rn(v, __bfloat162float(__float2bfloat16_rn(v)));
  lo = __fsub_rn(mid, __bfloat162float(__float2bfloat16_rn(mid)));
}

// The nibbles in bits 0-3 and 16-19 of t as a bf16 pair: the bits
// 0x4300 | n are the bf16 128 + n, and 128 + n - 128 is n exactly.
__device__ __forceinline__ uint32_t nib_pair(uint32_t t) {
  const uint32_t biased = (t & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&biased),
                                   __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// bf16 bits of four floats, packed two to a word.
__device__ __forceinline__ uint2 pack4(const float (&v)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// NT: n8 row tiles per block (1, 2, 4, 8 or 16; int4 1, 2 or 4); P:
// activation planes (1 for bf16 x without a norm, else 3); ZEROS: a zero
// point per group and column (int8; int4 reads its zeros at run time);
// SPLIT: f32 x split into its planes in the kernel (K4 and K3 with f32 x),
// else the planes are read from a.xp (bf16 x itself, or the norm's
// pre-pass); I4: packed int4 weight bytes, two activation runs a slice.
template <int NT, int P, bool ZEROS, bool SPLIT, bool I4>
struct Tile {
  static constexpr int H = I4 ? 2 : 1;                 // activation runs a slice
  static constexpr int MW = I4 ? 2 : 4;                // most n8 tiles a warp
  static constexpr int NW = NT < MW ? NT : MW;         // n8 tiles per warp
  static constexpr int WR = NT / NW;                   // row warps
  static constexpr int kThreads = 128 * WR;            // four column warps each
  static constexpr int BR = 8 * NT;                    // rows per block
  static constexpr int QPT = BR * (H * BK / 4) / kThreads; // SPLIT: x quads per thread
  static constexpr int WST = BK * BN;                  // weight bytes a stage
  static constexpr int XST = H * P * BR * BK * 2;      // plane bytes a stage
  static constexpr int STAGE = SPLIT ? WST : WST + XST;
  // stages in flight: three where a stage is large, so that two blocks of
  // 33-64 rows fit an SM
  static constexpr int S = STAGE > 24576 ? 3 : 4;
  static constexpr int SMEM = S * STAGE + (SPLIT ? XST : 0);
};

template <int NT, int P, bool ZEROS, bool SPLIT, bool I4>
__global__ void __launch_bounds__(Tile<NT, P, ZEROS, SPLIT, I4>::kThreads)
i8_kernel(const Args a) {
  using T = Tile<NT, P, ZEROS, SPLIT, I4>;
  constexpr int NW = T::NW, kThreads = T::kThreads, BR = T::BR, S = T::S, H = T::H;
  constexpr bool XG = ZEROS || I4;         // a rank-1 term per group
  // K1 (int4 with the norm's planes): the group sums come from the pre-pass
  constexpr bool PXG = I4 && P == 3 && !SPLIT;
  extern __shared__ __align__(16) unsigned char smem[];
  // stage s: weight [BK][BN] at s * STAGE, then (not SPLIT) planes
  // [H][P][BR][BK]; SPLIT: one plane buffer after the S stages. Rows of both
  // are 16-byte chunks XOR-swizzled by the row (xpos, and the weight's
  // in load), so the fragment reads hit distinct banks.

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wc = warp & 3;                   // column warp: columns [32 wc, 32 wc + 32)
  const int wr = warp >> 2;                  // row warp: rows [8 NW wr, 8 NW (wr + 1))
  const int g = lane >> 2;
  const int tg = lane & 3;
  // int4: row blocks fastest, so a column block's row blocks run side by
  // side and share its weight through L2
  const int col0 = (I4 ? blockIdx.y : blockIdx.x) * BN;
  const int row0 = (I4 ? blockIdx.x : blockIdx.y) * BR;
  const int gs = a.din / a.groups;           // int4: byte rows per group too
  const int spg = gs / BK;                   // slices per group
  // int4: splits of 128-row tiles of the a.din / 2 byte rows, the last one
  // taking a trailing 64-row slice
  const int krows = I4 ? a.din / 2 : a.din;
  const int per_split = I4 ? (max(krows / kTileRows, 1) + a.splits - 1) / a.splits
                           : (a.din / kTileRows + a.splits - 1) / a.splits;
  const int s_begin = blockIdx.z * per_split * (kTileRows / BK);
  const int s_end =
      I4 ? ((int)blockIdx.z + 1 == a.splits
                ? krows / BK
                : min(krows / BK, (int)(blockIdx.z + 1) * per_split * (kTileRows / BK)))
         : min(a.din / kTileRows, (int)(blockIdx.z + 1) * per_split) * (kTileRows / BK);
  // this lane's four columns, 4g .. 4g + 3 of its warp's 32
  const int lcol = col0 + 32 * wc + 4 * g;

  auto wstage = [&](int st) { return smem + st * T::STAGE; };
  // position of feature f of plane row r in a plane buffer
  auto xpos = [](int r, int f) { return r * BK + 8 * ((f >> 3) ^ ((r & 3) << 1)) + (f & 7); };
  auto xstage = [&](int st) {
    return reinterpret_cast<__nv_bfloat16*>(SPLIT ? smem + S * T::STAGE
                                                  : smem + st * T::STAGE + T::WST);
  };

  // slice t into stage st: the weight's 64 x 128 bytes (chunks swizzled)
  // and, unless SPLIT, the planes' BR rows x 64 features of each run
  auto load = [&](int t, int st) {
    uint8_t* dst = wstage(st);
    for (int e = tid; e < BK * (BN / 16); e += kThreads) {
      const int r = e >> 3;
      const int c = e & 7;
      uint8_t* d = dst + r * BN + 16 * (c ^ (((r >> 2) & 3) << 1));
      const int col = col0 + 16 * c;
      const int left = a.dout - col;         // bytes of this chunk inside dout
      const int8_t* s = a.w + (long long)(t * BK + r) * a.dout + col;
      if (a.wvec == 16) {
        cp_async16(d, left > 0 ? s : a.w, left > 0 ? 16 : 0);
      } else if (a.wvec == 4) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          cp_async4(d + 4 * q, left > 4 * q ? s + 4 * q : a.w, left > 4 * q ? 4 : 0);
        }
      } else {
#pragma unroll
        for (int b = 0; b < 16; ++b) d[b] = b < left ? (uint8_t)__ldg(s + b) : (uint8_t)0;
      }
    }
    if constexpr (!SPLIT) {
      __nv_bfloat16* xd = xstage(st);
      for (int e = tid; e < H * P * BR * 8; e += kThreads) {
        const int c = e & 7;
        const int r = (e >> 3) % BR;
        const int hp = (e >> 3) / BR;      // run * P + plane
        const int p = I4 ? hp % P : hp;
        const int f = (I4 ? (hp / P) * (a.din / 2) : 0) + t * BK + 8 * c;
        const bool ok = row0 + r < a.n;
        const __nv_bfloat16* src = a.xp + ((long long)p * a.n + row0 + r) * a.din + f;
        cp_async16(xd + hp * BR * BK + xpos(r, 8 * c), ok ? src : a.xp, ok ? 16 : 0);
      }
    }
  };

  // SPLIT: slice t of the f32 x into registers, then its planes into the
  // plane buffer; quad q is row q / (16 H), features 4 (q % 16) of run
  // (q / 16) % H
  auto load_x = [&](int t, float (&xr)[T::QPT][4]) {
#pragma unroll
    for (int j = 0; j < T::QPT; ++j) {
      const int q = tid + j * kThreads;
      const int r = I4 ? q >> 5 : q >> 4;
      const int f = (I4 ? ((q >> 4) & 1) * (a.din / 2) : 0) + t * BK + (q & 15) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row0 + r < a.n) {
        v = __ldg(reinterpret_cast<const float4*>(reinterpret_cast<const float*>(a.x)
                  + (long long)(row0 + r) * a.din + f));
      }
      xr[j][0] = v.x; xr[j][1] = v.y; xr[j][2] = v.z; xr[j][3] = v.w;
    }
  };
  auto store_x = [&](float (&xr)[T::QPT][4]) {
#pragma unroll
    for (int j = 0; j < T::QPT; ++j) {
      const int q = tid + j * kThreads;
      float mid[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(xr[j][e], mid[e], lo[e]);
      __nv_bfloat16* d = xstage(0) + (I4 ? ((q >> 4) & 1) * P * BR * BK : 0)
                         + xpos(I4 ? q >> 5 : q >> 4, (q & 15) * 4);
      *reinterpret_cast<uint2*>(d) = pack4(xr[j]);
      *reinterpret_cast<uint2*>(d + BR * BK) = pack4(mid);
      *reinterpret_cast<uint2*>(d + 2 * BR * BK) = pack4(lo);
    }
  };

  float acc[2][NW][4];                     // the current group's code sums
  float acch[I4 ? 2 : 1][I4 ? NW : 1][4];  // int4: the high run's group's
  float out[2][NW][4];                     // sum over groups of scale * acc
  // the current group's row sums: int8 [j][e % 2]; int4 the low run's
  // group in [j][0..1], the high run's in [j][2..3]
  float xg[XG ? NW : 1][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = out[m][j][e] = 0.f;
  if constexpr (I4) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < NW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acch[m][j][e] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < (XG ? NW : 1); ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xg[j][e] = 0.f;
  // scales and offsets of this lane's four columns: int8 (sc, zc); int4
  // the low run's group (sc, zc) and the high run's (sch, zch), zc = 8 + zero
  float sc[4], zc[4], sch[I4 ? 4 : 1], zch[I4 ? 4 : 1];
  float xr[SPLIT ? T::QPT : 1][4];

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s_begin + s < s_end) load(s_begin + s, s);
    cp_async_commit();
  }
  if constexpr (SPLIT) {
    load_x(s_begin, xr);
    store_x(xr);
  }

  for (int t = s_begin; t < s_end; ++t) {
    const int stage = (t - s_begin) % S;
    cp_async_wait<S - 2>();
    __syncthreads();        // slice t is staged; slice t - 1's stage is free
    {
      const int tn = t + S - 1;
      if (tn < s_end) load(tn, (tn - s_begin) % S);
      cp_async_commit();
    }
    if constexpr (SPLIT) {
      if (t + 1 < s_end) load_x(t + 1, xr);
    }
    if (t == s_begin || t % spg == 0) {    // the group's scales and zeros
      const long long si = (long long)(t / spg) * a.dout + lcol;
      const long long sh = si + (long long)(a.groups / 2) * a.dout;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool ok = lcol + c < a.dout;
        sc[c] = ok ? load_val(a.scales, a.s_bf16, si + c) : 0.f;
        if constexpr (I4) {
          zc[c] = 8.f + ((a.zeros && ok) ? a.zeros[si + c] : 0.f);
          sch[c] = ok ? load_val(a.scales, a.s_bf16, sh + c) : 0.f;
          zch[c] = 8.f + ((a.zeros && ok) ? a.zeros[sh + c] : 0.f);
        } else {
          zc[c] = (ZEROS && ok) ? a.zeros[si + c] : 0.f;
        }
      }
    }

    const uint8_t* wst = wstage(stage);
    const __nv_bfloat16* xst = xstage(stage);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // rows kk*16 + 4tg + i, columns lcol .. lcol + 3 (swizzled chunk 2wc + g/4)
      uint32_t wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = kk * 16 + 4 * tg + i;
        wv[i] = *reinterpret_cast<const uint32_t*>(
            wst + rr * BN + 16 * ((2 * wc + (g >> 2)) ^ (2 * tg)) + 4 * (g & 3));
      }
      if constexpr (I4) {
        // the same slots from the low nibbles (features r0 + kk*16 + 4tg ..
        // + 3, run 0) and the high ones (the same of run 1): byte j of
        // words 2h and 2h + 1 is column lcol + j at features 4tg + 2h and
        // 4tg + 2h + 1
        uint32_t al[2][4], ah[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t pr = __byte_perm(wv[2 * h], wv[2 * h + 1], j | ((j + 4) << 8));
            al[j >> 1][2 * h + (j & 1)] = nib_pair(pr);
            ah[j >> 1][2 * h + (j & 1)] = nib_pair(pr >> 4);
          }
        }
        // ones on the k slots of the low run for M slot g, of the high run
        // for g + 8: one mma sums half a step of both runs' features
        const uint32_t ones[4] = {kOnes, 0u, 0u, kOnes};
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int j = 0; j < NW; ++j) {
            const int r = wr * NW * 8 + 8 * j + g;
            const __nv_bfloat16* xb = xst + p * BR * BK + xpos(r, kk * 16 + 4 * tg);
            const uint2 bl = *reinterpret_cast<const uint2*>(xb);
            const uint2 bh = *reinterpret_cast<const uint2*>(xb + P * BR * BK);
            mma_bf16(acc[0][j], al[0], bl.x, bl.y);
            mma_bf16(acc[1][j], al[1], bl.x, bl.y);
            mma_bf16(acch[0][j], ah[0], bh.x, bh.y);
            mma_bf16(acch[1][j], ah[1], bh.x, bh.y);
            if constexpr (!PXG) {
              mma_bf16(xg[j], ones, bl.x, bh.x);
              mma_bf16(xg[j], ones, bl.y, bh.y);
            }
          }
        }
        continue;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) wv[i] ^= 0x80808080u;
      // af[m] = {a0, a1, a2, a3} of the 16-column tile m: a0 the M slot g
      // (column lcol + 2m) at features 4tg, 4tg+1; a1 the slot g + 8
      // (column lcol + 2m + 1) there; a2, a3 the same at features 4tg+2, +3
      uint32_t af[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          af[m][2 * h] = pack_hi(code_f32(wv[2 * h], 2 * m), code_f32(wv[2 * h + 1], 2 * m));
          af[m][2 * h + 1] = pack_hi(code_f32(wv[2 * h], 2 * m + 1),
                                     code_f32(wv[2 * h + 1], 2 * m + 1));
        }
      }
#pragma unroll
      for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int j = 0; j < NW; ++j) {
          const int r = wr * NW * 8 + 8 * j + g;
          const uint2 b = *reinterpret_cast<const uint2*>(
              xst + p * BR * BK + xpos(r, kk * 16 + 4 * tg));
          mma_bf16(acc[0][j], af[0], b.x, b.y);
          mma_bf16(acc[1][j], af[1], b.x, b.y);
          if (ZEROS) {
            const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
            mma_bf16(xg[j], ones, b.x, b.y);
          }
        }
      }
    }

    if ((t + 1) % spg == 0 || t + 1 == s_end) {   // the group's end here
      if constexpr (PXG) {
        // the pre-pass's sums of the whole groups; a split that ends inside
        // a group leaves the term to the split that ends the group
        const bool whole = (t + 1) % spg == 0;
        const int gl = t / spg;
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int row = row0 + wr * NW * 8 + 8 * j + 2 * tg + e;
            const bool ok = whole && row < a.n;
            const float* xs = group_sums(a) + (long long)row * a.groups + gl;
            xg[j][e] = ok ? xs[0] : 0.f;
            xg[j][2 + e] = ok ? xs[a.groups / 2] : 0.f;
          }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < NW; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 2 * m + (e >> 1);
            float v = acc[m][j][e];
            if (XG) v = fmaf(-zc[c], xg[j][e & 1], v);
            out[m][j][e] = fmaf(sc[c], v, out[m][j][e]);
            acc[m][j][e] = 0.f;
            if constexpr (I4) {          // then the high run's group
              v = fmaf(-zch[c], xg[j][2 + (e & 1)], acch[m][j][e]);
              out[m][j][e] = fmaf(sch[c], v, out[m][j][e]);
              acch[m][j][e] = 0.f;
            }
          }
#pragma unroll
      for (int j = 0; j < (XG ? NW : 1); ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) xg[j][e] = 0.f;
    }
    if constexpr (SPLIT) {
      __syncthreads();      // this slice's planes are consumed
      if (t + 1 < s_end) store_x(xr);
    }
  }

  // out[m][j][e]: column lcol + 2m + e/2, row 8 NW wr + 8j + 2tg + e%2
#pragma unroll
  for (int j = 0; j < NW; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row = row0 + wr * NW * 8 + 8 * j + 2 * tg + (e & 1);
        const int col = lcol + 2 * m + (e >> 1);
        if (row >= a.n || col >= a.dout) continue;
        const long long oi = (long long)row * a.dout + col;
        if (a.splits > 1) {
          a.ws[(long long)blockIdx.z * a.n * a.dout + oi] = out[m][j][e];
        } else {
          store_val(a.out, a.o_bf16, oi, out[m][j][e]);
        }
      }
    }
  }
}

// The norm's pre-pass (K5, K1), one block of kPrep threads per row: the row's inverse RMS
// over its din features (a fixed order: lanes, then warps in order), then
// the three planes of its normed activations (x * inv) * ln, written to a.xp
// [3][n][din]; XGS (K1): also each group's sum of those f32 values, warp w
// taking groups w, w + 32, ... (lanes in a fixed order, then a butterfly),
// written after the planes (group_sums).
constexpr int kPrep = 1024;
template <bool XGS>
__global__ void __launch_bounds__(kPrep) prep_kernel(const Args a) {
  __shared__ float part[kPrep / 32];
  __shared__ float rinv;
  const long long base = (long long)blockIdx.x * a.din;
  float s = 0.f;
#pragma unroll 4
  for (int f = threadIdx.x; f < a.din; f += kPrep) {
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
    for (int w = 1; w < kPrep / 32; ++w) t += part[w];
    rinv = rsqrtf(t / (float)a.din + a.eps);
  }
  __syncthreads();
  const long long plane = (long long)a.n * a.din;
#pragma unroll 4
  for (int f = threadIdx.x; f < a.din; f += kPrep) {
    const float v = __fmul_rn(__fmul_rn(load_val(a.x, a.x_bf16, base + f), rinv), a.ln[f]);
    float mid, lo;
    split3(v, mid, lo);
    a.xp[base + f] = __float2bfloat16_rn(v);
    a.xp[plane + base + f] = __float2bfloat16_rn(mid);
    a.xp[2 * plane + base + f] = __float2bfloat16_rn(lo);
  }
  if constexpr (XGS) {
    const int gs = a.din / a.groups;
    const int lane = threadIdx.x & 31;
    for (int g = threadIdx.x >> 5; g < a.groups; g += kPrep / 32) {
      float s = 0.f;
      for (int f = g * gs + lane; f < (g + 1) * gs; f += 32) {
        s += __fmul_rn(__fmul_rn(load_val(a.x, a.x_bf16, base + f), rinv), a.ln[f]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) group_sums(a)[(long long)blockIdx.x * a.groups + g] = s;
    }
  }
}

template <int NT, int P, bool ZEROS, bool SPLIT, bool I4>
int launch(dim3 grid, cudaStream_t stream, const Args& a) {
  using T = Tile<NT, P, ZEROS, SPLIT, I4>;
  static bool configured = false;        // the opt-in above 48 KB, once
  if (!configured) {
    const int err = (int)cudaFuncSetAttribute(
        i8_kernel<NT, P, ZEROS, SPLIT, I4>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        T::SMEM);
    if (err) return err;
    configured = true;
  }
  i8_kernel<NT, P, ZEROS, SPLIT, I4><<<grid, T::kThreads, T::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 x: one plane from x itself; a norm: three planes from the pre-pass;
// f32 x without a norm: three planes split in the kernel. int4 reads its
// zeros at run time.
template <int NT, bool I4>
int launch_nt(dim3 grid, cudaStream_t stream, const Args& a) {
  if (a.ln) return launch<NT, 3, false, false, I4>(grid, stream, a);
  if (a.x_bf16) {
    return (a.zeros && !I4) ? launch<NT, 1, !I4, false, I4>(grid, stream, a)
                            : launch<NT, 1, false, false, I4>(grid, stream, a);
  }
  return (a.zeros && !I4) ? launch<NT, 3, !I4, true, I4>(grid, stream, a)
                          : launch<NT, 3, false, true, I4>(grid, stream, a);
}

// Checks a product's shape and fills its arguments. Returns 0 or kErrShape.
template <bool I4>
int make_args(Args& a, const void* x, int x_bf16, int n, int din, const void* w,
              int dout, const void* scales, int s_bf16, const void* zeros, int groups,
              const void* ln, float eps, void* out, int o_bf16, int splits, void* ws,
              void* planes) {
  if (n <= 0 || din <= 0 || dout <= 0 || groups <= 0 || din % groups) return kErrShape;
  const int gs = din / groups;
  // int8: groups of a multiple of 128 rows; int4: an even group count (each
  // nibble plane spans whole groups) of a multiple of 64 features
  if (I4 ? (groups % 2 || gs % BK) : gs % kTileRows) return kErrShape;
  if (ln && (!planes || zeros)) return kErrShape;
  const int krows = I4 ? din / 2 : din;
  const int tiles = krows / kTileRows > 0 ? krows / kTileRows : 1;
  if (splits < 1 || splits > tiles || (splits > 1 && !ws)) return kErrShape;
  if (reinterpret_cast<uintptr_t>(x) % 16 || reinterpret_cast<uintptr_t>(planes) % 16) {
    return kErrShape;
  }
  const int max_rows = I4 ? kMaxRowsI4 : kMaxRows;
  const long long row_blocks = (n + max_rows - 1) / max_rows;
  const long long col_blocks = (dout + BN - 1) / BN;
  if ((I4 ? col_blocks : row_blocks) > 65535 || splits > 65535) return kErrShape;

  a.x = x; a.x_bf16 = x_bf16; a.n = n; a.din = din;
  a.w = reinterpret_cast<const int8_t*>(w); a.dout = dout;
  a.scales = scales; a.s_bf16 = s_bf16;
  a.zeros = reinterpret_cast<const float*>(zeros); a.groups = groups;
  a.ln = reinterpret_cast<const float*>(ln); a.eps = eps;
  a.xp = reinterpret_cast<__nv_bfloat16*>(ln ? planes : const_cast<void*>(x));
  a.out = out; a.o_bf16 = o_bf16;
  a.splits = splits; a.ws = reinterpret_cast<float*>(ws);
  const uintptr_t wp = reinterpret_cast<uintptr_t>(w);
  a.wvec = (dout % 16 == 0 && wp % 16 == 0) ? 16 : (dout % 4 == 0 && wp % 4 == 0) ? 4 : 1;
  return 0;
}

// The pre-pass (with ln) and the kernel: the output, or with splits > 1
// the f32 partials in a.ws.
template <bool I4>
int launch_product(const Args& a, cudaStream_t s) {
  const int n = a.n;
  if (a.ln) {
    prep_kernel<I4><<<n, kPrep, 0, s>>>(a);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int max_rows = I4 ? kMaxRowsI4 : kMaxRows;
  const long long row_blocks = (n + max_rows - 1) / max_rows;
  const long long col_blocks = (a.dout + BN - 1) / BN;
  const int nt = I4 ? (n > 16 ? 4 : n > 8 ? 2 : 1)
                    : (n > 64 ? 16 : n > 32 ? 8 : n > 16 ? 4 : n > 8 ? 2 : 1);
  const unsigned rb = (unsigned)(n > max_rows ? row_blocks : 1);
  const dim3 grid = I4 ? dim3(rb, (unsigned)col_blocks, a.splits)
                       : dim3((unsigned)col_blocks, rb, a.splits);
  switch (nt) {
    case 1: return launch_nt<1, I4>(grid, s, a);
    case 2: return launch_nt<2, I4>(grid, s, a);
    case 4: return launch_nt<4, I4>(grid, s, a);
    default:
      if constexpr (I4) {
        return kErrShape;
      } else {
        return nt == 8 ? launch_nt<8, false>(grid, s, a) : launch_nt<16, false>(grid, s, a);
      }
  }
}

int grid_stride_blocks(long long total) {
  return (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
}

// The pass after a product's split partials, [splits][n][dout] f32: their
// sum in split order, then the residual (bf16 or f32, or none) added in f32
// and the result rounded to the output, or (SWIGLU) silu(g) * u of the
// pairs g = column j, u = column dout/2 + j. Every product with splits > 1
// ends in it; K2 and K6's products always do (one partial when a product
// ran unsplit into the partials buffer). Elementwise, so a row's bits do
// not depend on the row count. Its own argument struct: the main kernel's
// Args stays as it is.
struct Epi {
  const float* part;
  long long total;       // n * dout
  int splits;
  int dout;
  const void* resid;     // [n, dout], or null
  int r_bf16;
  void* out;             // [n, dout], or [n, dout / 2] (SWIGLU)
  int o_bf16;
};

template <bool SWIGLU>
__global__ void __launch_bounds__(256) splitk_epilogue_kernel(const Epi e) {
  const long long m = SWIGLU ? e.total / 2 : e.total;
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < m;
       i += (long long)gridDim.x * 256) {
    if constexpr (SWIGLU) {
      const int h = e.dout / 2;
      const long long gi = (i / h) * e.dout + i % h;
      float g = e.part[gi], u = e.part[gi + h];
      for (int z = 1; z < e.splits; ++z) {
        g += e.part[z * e.total + gi];
        u += e.part[z * e.total + gi + h];
      }
      store_val(e.out, e.o_bf16, i, g * (1.f / (1.f + expf(-g))) * u);
    } else {
      float s = e.part[i];
      for (int z = 1; z < e.splits; ++z) s += e.part[z * e.total + i];
      if (e.resid) s = load_val(e.resid, e.r_bf16, i) + s;
      store_val(e.out, e.o_bf16, i, s);
    }
  }
}

template <bool SWIGLU>
int epilogue(const float* part, int splits, int n, int dout, const void* resid, int r_bf16,
             void* out, int o_bf16, cudaStream_t s) {
  Epi e;
  e.part = part; e.total = (long long)n * dout; e.splits = splits; e.dout = dout;
  e.resid = resid; e.r_bf16 = r_bf16; e.out = out; e.o_bf16 = o_bf16;
  splitk_epilogue_kernel<SWIGLU>
      <<<grid_stride_blocks(SWIGLU ? e.total / 2 : e.total), 256, 0, s>>>(e);
  return (int)cudaGetLastError();
}

// Checks the shape, runs the pre-pass (with ln), the kernel and (splits >
// 1) the ordered sum of the splits. Returns 0, a CUDA error code from a
// launch, or kErrShape.
template <bool I4>
int run(const void* x, int x_bf16, int n, int din, const void* w, int dout,
        const void* scales, int s_bf16, const void* zeros, int groups, const void* ln,
        float eps, void* out, int o_bf16, int splits, void* ws, void* planes,
        void* stream) {
  Args a;
  int err = make_args<I4>(a, x, x_bf16, n, din, w, dout, scales, s_bf16, zeros, groups, ln,
                          eps, out, o_bf16, splits, ws, planes);
  if (err) return err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  err = launch_product<I4>(a, s);
  if (err || splits == 1) return err;
  return epilogue<false>(a.ws, splits, n, dout, nullptr, 0, out, o_bf16, s);
}

// The tail's workspace, in bytes, each part 256-byte aligned: x' f32 [n, d]
// (K2 only, dh > 0), the planes bf16 [3, n, d] and group sums f32 [n, gg]
// of wgu's pre-pass, ff f32 [n, f], and one partials buffer f32 for the
// largest of the three products' [splits, n, dout] (the products run in
// stream order, so each reuses it).
long long align256(long long b) { return (b + 255) / 256 * 256; }

long long tail_layout(int n, int dh, int d, int f, int dout, int gg, int so, int sg, int sd,
                      long long off[4]) {
  const long long nn = n;
  off[0] = 0;
  off[1] = dh > 0 ? align256(nn * d * 4) : 0;
  off[2] = off[1] + align256(3 * nn * d * 2 + nn * gg * 4);
  off[3] = off[2] + align256(nn * f * 4);
  long long part = (long long)sg * nn * 2 * f;
  if ((long long)sd * nn * dout > part) part = (long long)sd * nn * dout;
  if (dh > 0 && (long long)so * nn * d > part) part = (long long)so * nn * d;
  return off[3] + align256(part * 4);
}

}  // namespace

// y[n, dout] = prologue(x) @ ((code - zero) * scale), f32-exact operands on
// the tensor cores, f32 accumulation, rounded once to the output's type.
// ln may be null (K4); with ln (K5) zeros must be null and planes is a
// [3, n, din] bf16 workspace for the pre-pass. ws is an [splits, n, dout]
// f32 workspace (unused when splits == 1). Returns 0, a CUDA error code from
// a launch, or kErrShape for a shape the kernel does not take.
extern "C" int hsd_gptq_i8(const void* x, int x_bf16, int n, int din,
                           const void* w, int dout, const void* scales,
                           int s_bf16, const void* zeros, int groups,
                           const void* ln, float eps, void* out, int o_bf16,
                           int splits, void* ws, void* planes, void* stream) {
  return run<false>(x, x_bf16, n, din, w, dout, scales, s_bf16, zeros, groups, ln, eps,
                    out, o_bf16, splits, ws, planes, stream);
}

// y[n, dout] = prologue(x) @ ((nibble - 8 - zero) * scale) for packed int4
// w [din/2, dout]: K3 (ln null) and K1 (ln, zeros null), with the
// arguments and workspaces of hsd_gptq_i8, except that K1's planes
// workspace holds [n, groups] f32 group sums after its three bf16 planes
// (3 n din + 2 n groups bf16 elements). Splits count 128-row tiles of the
// packed rows.
extern "C" int hsd_gptq_i4(const void* x, int x_bf16, int n, int din,
                           const void* w, int dout, const void* scales,
                           int s_bf16, const void* zeros, int groups,
                           const void* ln, float eps, void* out, int o_bf16,
                           int splits, void* ws, void* planes, void* stream) {
  return run<true>(x, x_bf16, n, din, w, dout, scales, s_bf16, zeros, groups, ln, eps,
                   out, o_bf16, splits, ws, planes, stream);
}

// Bytes of hsd_gptq_tail's workspace: dh = 0 for K6 (no wo product); so,
// sg, sd the splits of wo, wgu and wdown.
extern "C" long long hsd_tail_workspace(int n, int dh, int d, int f, int dout, int gg,
                                        int so, int sg, int sd) {
  long long off[4];
  return tail_layout(n, dh, d, f, dout, gg, so, sg, sd, off);
}

// K2 (dh > 0): out = x' + (silu(g) * u) @ deq(wdown), with x' = resid +
// x @ deq(wo) kept f32 and [g | u] = rmsnorm(x', ln) @ deq(wgu) in f32. K6
// (dh = 0, wo and resid null): x is the MLP's input and out = (silu(g) * u)
// @ deq(wdown). Every weight packed int4, symmetric: wo [dh/2, d], wgu
// [d/2, 2f], wdown [f/2, dout] (K2: dout = d), each with its scales, group
// count and splits. Three products of the int4 kernel (wo: x's planes, or
// f32 x split in the kernel; wgu: the pre-pass's planes of x'; wdown: f32
// ff split in the kernel), each into the f32 partials buffer and followed
// by its epilogue pass: x' = resid + the wo sum; ff = silu(g) * u; out =
// x' + the wdown sum (K6: the sum), rounded once. ws: hsd_tail_workspace's
// bytes, 16-byte aligned. Returns 0, a CUDA error code, or kErrShape.
extern "C" int hsd_gptq_tail(const void* x, int x_bf16, const void* resid, int r_bf16,
                             int n, int dh, int d, int f, int dout,
                             const void* wo, const void* so, int so_bf16, int go, int splits_o,
                             const void* wgu, const void* sg, int sg_bf16, int gg, int splits_g,
                             const void* wd, const void* sd, int sd_bf16, int gd, int splits_d,
                             const void* ln, float eps, void* out, int o_bf16, void* ws,
                             long long ws_bytes, void* stream) {
  const bool k2 = dh > 0;
  if (k2 != (wo != nullptr) || k2 != (resid != nullptr) || !ln || n <= 0) return kErrShape;
  if (k2 && dout != d) return kErrShape;
  long long off[4];
  if (!ws || reinterpret_cast<uintptr_t>(ws) % 16 ||
      ws_bytes < tail_layout(n, dh, d, f, dout, gg, splits_o, splits_g, splits_d, off)) {
    return kErrShape;
  }
  char* base = reinterpret_cast<char*>(ws);
  float* xp = reinterpret_cast<float*>(base + off[0]);
  void* planes = base + off[1];
  float* ff = reinterpret_cast<float*>(base + off[2]);
  float* part = reinterpret_cast<float*>(base + off[3]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  Args a;
  int err;
  if (k2) {
    err = make_args<true>(a, x, x_bf16, n, dh, wo, d, so, so_bf16, nullptr, go, nullptr, 0.f,
                          part, 0, splits_o, part, nullptr);
    if (!err) err = launch_product<true>(a, s);
    if (!err) err = epilogue<false>(part, splits_o, n, d, resid, r_bf16, xp, 0, s);
    if (err) return err;
  }
  err = make_args<true>(a, k2 ? xp : x, k2 ? 0 : x_bf16, n, d, wgu, 2 * f, sg, sg_bf16,
                        nullptr, gg, ln, eps, part, 0, splits_g, part, planes);
  if (!err) err = launch_product<true>(a, s);
  if (!err) err = epilogue<true>(part, splits_g, n, 2 * f, nullptr, 0, ff, 0, s);
  if (err) return err;
  err = make_args<true>(a, ff, 0, n, f, wd, dout, sd, sd_bf16, nullptr, gd, nullptr, 0.f,
                        part, 0, splits_d, part, nullptr);
  if (!err) err = launch_product<true>(a, s);
  if (!err) err = epilogue<false>(part, splits_d, n, dout, k2 ? xp : nullptr, 0, out, o_bf16, s);
  return err;
}

extern "C" const char* hsd_i8_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the GPTQ tensor-core kernel";
  return cudaGetErrorString((cudaError_t)code);
}
