// Route A's dequantize: int8 or packed-int4 GPTQ codes to a bf16 (or f32)
// weight in one pass, for Hopper (sm_90a).
//
// Replaces no Pallas kernel. On this route the JAX package dequantizes in
// XLA code (`dequantize` and the `n_rows > 64` branch of `_gptq_matmul_xla`,
// hsd_tpu/ops/linear.py:124-143, 168-170) and leaves the large product to
// one einsum; the port's `ops/linear.dequant_matmul` does the same with one
// torch.matmul. This kernel is the dequantize in front of it: every
// quantized product of more than 128 rows a slot outside the bf16-operand
// mode (the prefills) dequantizes its whole weight first, and as plain
// PyTorch that took about seven elementwise passes through an f32 [din, dout]
// buffer (~29 bytes of device traffic a weight).
//
// Arithmetic, bit for bit that of the plain version
// (ops/gptq_cuda.dequantize_int4_plain / dequantize_int8_plain, then
// .to(dtype)): v = float(code) (int4: stored nibble - 8, exact); with zero
// points v = v - zero, rounded once in f32; v = v * float(scale), rounded
// once in f32; then rounded once to the output type, to nearest even. The
// subtract and the multiply are __fsub_rn / __fmul_rn, which the compiler
// never contracts into an FMA.
//
// Bound: bytes. A packed-int4 weight reads half a byte of code and writes
// two bytes of bf16 (int8: one in, two out), plus its group's scale (and
// zero point) once for each column of a group. Target wgu 5120 x 27648, int4,
// bf16 scales, group 128: 70.8 MB of codes, 2.2 MB of scales and 283.1 MB of
// output, 0.106 ms at 3.35 TB/s. The design reads and writes every byte
// once, in order: a thread owns 8 columns of 4 consecutive code rows; it
// starts the four 8-byte code loads first (int4: 8 columns of input rows
// i..i+3 and i + din/2..i + din/2 + 3), loads the 8 scales (and zero points)
// of a group once for the rows that share it, and writes each output row's
// 8 values with one 16-byte store (bf16; two for f32). Neighbouring threads
// take neighbouring columns, so a warp's code loads and its stores to a row
// are each one contiguous run. 256 threads a block, one (row quad, column
// chunk) a thread, behind a grid-stride loop for grids past kMaxBlocks: no
// shared memory, no synchronisation. At the 14B target's shapes (H100
// 80GB HBM3, 700 W) one item a thread ran at 72-83% of the bound, a grid
// of 16 blocks an SM striding over them at 72-80%, one code row a thread
// at 69-78%; evict-first stores moved nothing. A ragged dout, or a
// view whose rows do not keep those accesses aligned, takes the
// element-wise form of the same arithmetic.
//
// Layouts (ops/linear.QuantizedLinear): qweight [din, dout] int8 codes, or
// [din/2, dout] uint8 split-half (byte row i holds input row i in its low
// nibble and row i + din/2 in its high nibble, each as code + 8); scales
// [groups, dout], bf16 or f32; zeros [groups, dout] f32 or null; group g
// covers input rows [g*gs, (g+1)*gs), gs = din / groups. Each input takes
// its own row stride (in elements) with the output dimension contiguous, so
// a layer or expert view of a stacked weight needs no copy. The output is a
// contiguous [din, dout], bf16 or f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kCols = 8;                // output columns a thread
constexpr int kRows = 4;                // code rows a thread
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1 << 20;     // the grid's cap; past it threads stride
constexpr int kErrShape = 100000;       // unsupported shape or layout

struct DeqArgs {
  const uint8_t* q;         // code rows (int8 codes or packed bytes)
  long long q_ld;           // elements (bytes) between code rows
  int rows;                 // code rows: din, or din / 2 packed
  int dout;
  int chunks;               // ceil(dout / kCols)
  int items;                // ceil(rows / kRows) * chunks
  const void* scales;       // [groups, dout] bf16 or f32
  long long s_ld;
  const float* zeros;       // [groups, dout] f32, or null
  long long z_ld;
  int gs;                   // input rows a group
  void* out;                // [din, dout] bf16 or f32, contiguous
  int vec;                  // every full chunk's accesses are aligned
};

// the scale and zero point of `kCols` columns of group row g (columns past
// `ncol` read as 0 and are never stored)
template <bool kSBf16, bool kZeros>
__device__ __forceinline__ void load_group(const DeqArgs& a, int g, int c0, int ncol,
                                           bool vec, float (&s)[kCols], float (&z)[kCols]) {
  const long long so = (long long)g * a.s_ld + c0;
  const long long zo = (long long)g * a.z_ld + c0;
  if (vec) {
    if (kSBf16) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          reinterpret_cast<const __nv_bfloat16*>(a.scales) + so);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int k = 0; k < kCols / 2; ++k) {
        const float2 f = __bfloat1622float2(h[k]);
        s[2 * k] = f.x;
        s[2 * k + 1] = f.y;
      }
    } else {
      const float4* p = reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(a.scales) + so);
      const float4 lo = p[0], hi = p[1];
      s[0] = lo.x; s[1] = lo.y; s[2] = lo.z; s[3] = lo.w;
      s[4] = hi.x; s[5] = hi.y; s[6] = hi.z; s[7] = hi.w;
    }
    if (kZeros) {
      const float4* p = reinterpret_cast<const float4*>(a.zeros + zo);
      const float4 lo = p[0], hi = p[1];
      z[0] = lo.x; z[1] = lo.y; z[2] = lo.z; z[3] = lo.w;
      z[4] = hi.x; z[5] = hi.y; z[6] = hi.z; z[7] = hi.w;
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const bool in = c < ncol;
    if (kSBf16) {
      s[c] = in ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(a.scales)[so + c])
                : 0.f;
    } else {
      s[c] = in ? reinterpret_cast<const float*>(a.scales)[so + c] : 0.f;
    }
    z[c] = (kZeros && in) ? a.zeros[zo + c] : 0.f;
  }
}

__device__ __forceinline__ void store16(uint4* p, const uint4& v) { *p = v; }

// output row r, columns [c0, c0 + ncol), from the codes of one plane of a
// code row (8 bytes, column c in byte c): (code - zero) * scale, each step
// rounded once in f32, then rounded once to the output type
template <bool kPacked, bool kSBf16, bool kZeros, bool kOBf16>
__device__ __forceinline__ void emit_row(const DeqArgs& a, const uint2& raw, bool high,
                                         const float (&s)[kCols], const float (&z)[kCols],
                                         int r, int c0, int ncol, bool vec) {
  float v[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const uint32_t b = ((c < 4 ? raw.x : raw.y) >> (8 * (c & 3))) & 0xffu;
    float code;
    if (kPacked) {
      code = (float)((int)(high ? b >> 4 : b & 15u) - 8);
    } else {
      code = (float)(int8_t)(uint8_t)b;
    }
    const float t = kZeros ? __fsub_rn(code, z[c]) : code;
    v[c] = __fmul_rn(t, s[c]);
  }
  const long long o = (long long)r * a.dout + c0;
  if (kOBf16) {
    __nv_bfloat16* out = reinterpret_cast<__nv_bfloat16*>(a.out) + o;
    if (vec) {
      uint4 packed;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
      for (int k = 0; k < kCols / 2; ++k) h[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
      store16(reinterpret_cast<uint4*>(out), packed);
    } else {
      for (int c = 0; c < ncol; ++c) out[c] = __float2bfloat16_rn(v[c]);
    }
  } else {
    float* out = reinterpret_cast<float*>(a.out) + o;
    if (vec) {
      uint4 lo, hi;
      lo.x = __float_as_uint(v[0]); lo.y = __float_as_uint(v[1]);
      lo.z = __float_as_uint(v[2]); lo.w = __float_as_uint(v[3]);
      hi.x = __float_as_uint(v[4]); hi.y = __float_as_uint(v[5]);
      hi.z = __float_as_uint(v[6]); hi.w = __float_as_uint(v[7]);
      store16(reinterpret_cast<uint4*>(out), lo);
      store16(reinterpret_cast<uint4*>(out) + 1, hi);
    } else {
      for (int c = 0; c < ncol; ++c) out[c] = v[c];
    }
  }
}

// the output rows of one plane of kRows code rows from r0: the rows' groups
// are looked up one by one, and a group's scales (and zero points) are
// loaded once for the rows that share it
template <bool kPacked, bool kSBf16, bool kZeros, bool kOBf16>
__device__ __forceinline__ void emit_plane(const DeqArgs& a, const uint2 (&raw)[kRows],
                                           bool high, int r0, int nrow, int c0, int ncol,
                                           bool vec) {
  const int base = high ? a.rows : 0;      // the high plane's output rows
  float s[kCols], z[kCols];
  int g_cur = -1;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if (k < nrow) {
      const int r = base + r0 + k;
      const int g = r / a.gs;
      if (g != g_cur) {
        load_group<kSBf16, kZeros>(a, g, c0, ncol, vec, s, z);
        g_cur = g;
      }
      emit_row<kPacked, kSBf16, kZeros, kOBf16>(a, raw[k], high, s, z, r, c0, ncol, vec);
    }
  }
}

template <bool kPacked, bool kSBf16, bool kZeros, bool kOBf16>
__global__ void __launch_bounds__(kThreads) dequant_kernel(const DeqArgs a) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long it = (long long)blockIdx.x * kThreads + threadIdx.x; it < a.items;
       it += stride) {
    const int i = (int)it;
    const int rb = i / a.chunks;
    const int r0 = rb * kRows;
    const int nrow = min(kRows, a.rows - r0);
    const int c0 = (i - rb * a.chunks) * kCols;
    const int ncol = min(kCols, a.dout - c0);
    const bool vec = a.vec && ncol == kCols;
    // every code load of the thread first, then the arithmetic and stores
    uint2 raw[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      raw[k] = make_uint2(0u, 0u);
      if (k < nrow) {
        const uint8_t* qp = a.q + (long long)(r0 + k) * a.q_ld + c0;
        if (vec) {
          raw[k] = *reinterpret_cast<const uint2*>(qp);
        } else {
          for (int c = 0; c < ncol; ++c) {
            if (c < 4) raw[k].x |= (uint32_t)qp[c] << (8 * c);
            else raw[k].y |= (uint32_t)qp[c] << (8 * (c - 4));
          }
        }
      }
    }
    emit_plane<kPacked, kSBf16, kZeros, kOBf16>(a, raw, false, r0, nrow, c0, ncol, vec);
    if (kPacked) {
      emit_plane<kPacked, kSBf16, kZeros, kOBf16>(a, raw, true, r0, nrow, c0, ncol, vec);
    }
  }
}

template <bool kPacked, bool kSBf16, bool kZeros, bool kOBf16>
int launch(const DeqArgs& a, int grid, cudaStream_t s) {
  dequant_kernel<kPacked, kSBf16, kZeros, kOBf16><<<grid, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

template <bool kPacked, bool kSBf16, bool kZeros>
int launch_out(const DeqArgs& a, int out_bf16, int grid, cudaStream_t s) {
  return out_bf16 ? launch<kPacked, kSBf16, kZeros, true>(a, grid, s)
                  : launch<kPacked, kSBf16, kZeros, false>(a, grid, s);
}

template <bool kPacked>
int launch_packed(const DeqArgs& a, int s_bf16, int out_bf16, int grid, cudaStream_t s) {
  if (s_bf16) {
    return a.zeros ? launch_out<kPacked, true, true>(a, out_bf16, grid, s)
                   : launch_out<kPacked, true, false>(a, out_bf16, grid, s);
  }
  return a.zeros ? launch_out<kPacked, false, true>(a, out_bf16, grid, s)
                 : launch_out<kPacked, false, false>(a, out_bf16, grid, s);
}

bool aligned(const void* p, long long ld, int esize) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (ld * esize) % 16 == 0;
}

}  // namespace

// out[din, dout] = (code - zero) * scale, rounded to out's type (bf16 if
// out_bf16, else f32). q: int8 codes [rows = din, dout], or (packed) split-half
// bytes [rows = din / 2, dout], row stride q_ld; scales [groups, dout] (bf16 if
// s_bf16, else f32), row stride s_ld; zeros [groups, dout] f32 (may be null),
// row stride z_ld; strides in elements, the output dimension contiguous.
// Returns 0, a CUDA error code, or kErrShape.
extern "C" int hsd_dequant(const void* q, int packed, long long q_ld, int rows, int dout,
                           const void* scales, int s_bf16, long long s_ld, int groups,
                           const void* zeros, long long z_ld, void* out, int out_bf16,
                           void* stream) {
  if (!q || !scales || !out || rows <= 0 || dout <= 0 || groups <= 0) {
    return kErrShape;
  }
  const long long din = packed ? 2LL * rows : rows;
  if (din % groups || q_ld < dout || s_ld < dout || (zeros && z_ld < dout)) return kErrShape;
  const long long chunks = (dout + kCols - 1) / kCols;
  const long long items = (rows + kRows - 1) / kRows * chunks;
  if (items > INT_MAX) return kErrShape;
  DeqArgs a;
  a.q = reinterpret_cast<const uint8_t*>(q); a.q_ld = q_ld;
  a.rows = rows; a.dout = dout; a.chunks = (int)chunks; a.items = (int)items;
  a.scales = scales; a.s_ld = s_ld;
  a.zeros = reinterpret_cast<const float*>(zeros); a.z_ld = z_ld;
  a.gs = (int)(din / groups);
  a.out = out;
  // 8-byte code loads, 16-byte scale, zero-point and output accesses
  a.vec = dout % kCols == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0 && q_ld % 8 == 0 &&
          aligned(scales, s_ld, s_bf16 ? 2 : 4) && (!zeros || aligned(zeros, z_ld, 4)) &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long want = (items + kThreads - 1) / kThreads;
  const int grid = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return packed ? launch_packed<true>(a, s_bf16, out_bf16, grid, s)
                : launch_packed<false>(a, s_bf16, out_bf16, grid, s);
}

extern "C" const char* hsd_dequant_error_string(int code) {
  if (code == kErrShape) return "shape or layout not supported by the dequantize kernel";
  return cudaGetErrorString((cudaError_t)code);
}
