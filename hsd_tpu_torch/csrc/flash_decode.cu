// Flash-decode attention (K8) for Hopper (sm_90a).
//
// Hand-written counterpart of the Pallas kernel `_kernel` in
// hsd_tpu/ops/flash_decode.py: one sequence's queries q [T, H, d] attend to
// one layer's cache buffers K, V [S, Hkv, d] with online softmax, GQA without
// a repeat of K/V (rep = H / Hkv query heads share a kv head), the index mask
// key_pos <= q_index[t] && key_pos >= start, an optional [T, T] additive bias
// on the slots [kv_length, kv_length + T) (tree attention) and an optional
// rotate-half RoPE of the raw queries, which then stay f32. A fully masked
// query row gives zeros (acc / max(l, 1e-30) with l == 0).
//
// Design. A TPU grid walks S in order and carries (max, denominator,
// accumulator) in VMEM; blocks of a Hopper grid run in no order. Batch 1 has
// only Hkv = 8 kv heads, far fewer than 132 SMs, so S is split into chunks of
// a size fixed by S alone (ops/flash_decode.chunk_for). Pass 1: a block owns
// one kv head, up to 16 query rows (two per warp) and one chunk; it stages
// the chunk's keys and values in shared memory 32 at a time with 16-byte
// loads, and each warp runs the online softmax of its two rows over them in
// f32 (one key per lane; the scores' dot products on the CUDA cores with
// float4 shared-memory reads of the key row, read once for both rows; p
// rounded to V's dtype before PV as the Pallas kernel does). It writes each
// row's (max, denominator, accumulator) of the chunk to a workspace. Pass 2
// combines the chunks of each row in chunk order. A row's arithmetic never
// depends on the other rows of its launch, so its bits are the same at any
// T; there are no atomics.
//
// Bound on the card: the K and V bytes of the S slots, read once (at decode
// shapes the queries, bias and output are small beside them); the
// operations, 4 * T * H * S * d, stay far below the byte time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 2;            // query rows sharing a warp's key reads
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kKeys = 32;                  // keys per staged tile: one per lane
constexpr int kPad = 4;                    // keeps a lane's float4 reads conflict-free
constexpr float kNeg = -1e30f;
constexpr int kErrShape = 100000;

struct Args {
  const void* q;
  long long ldq;            // elements between query rows t and t+1
  const void* k;
  const void* v;
  const long long* q_index; // [T]
  const long long* start;   // [1]
  int kv_length;
  const float* bias;        // [T, T] or null
  const float* cos2;        // [T, d] or null (then q is already rotated)
  const float* sin2;
  int T, H, Hkv, S;
  int chunk;                // keys per chunk
  float scale;
  float* ws_acc;            // [n_chunks, Hkv, rep*T, d]
  float* ws_ml;             // [n_chunks, Hkv, rep*T, 2]: max, denominator
  void* out;                // [T, H, d]
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of a K or V row (4 f32 or 8 bf16 values) as floats
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// p cast to V's dtype before the PV product
__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int D, typename E>
__global__ void __launch_bounds__(kThreads) flash_partial_kernel(const Args a) {
  constexpr int C = D / 32;                  // accumulator dims per lane
  constexpr int V16 = 16 / sizeof(E);        // values per 16-byte load
  constexpr int R = kRowsPerWarp;
  __shared__ __align__(16) float ks[kKeys][D + kPad];
  __shared__ __align__(16) float vs[kKeys][D];
  __shared__ __align__(16) float qs[kRows][D];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.z;
  const int rep = a.H / a.Hkv;
  const int rT = rep * a.T;
  const E* K = reinterpret_cast<const E*>(a.k);
  const E* V = reinterpret_cast<const E*>(a.v);

  // this warp's rows r * T + t of kv head h, and their query positions
  int t_of[R];
  long long qi[R];
  bool live[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = blockIdx.y * kRows + warp * R + i;
    live[i] = row < rT;
    const int r = live[i] ? row / a.T : 0;
    const int t = live[i] ? row % a.T : 0;
    t_of[i] = t;
    qi[i] = live[i] ? a.q_index[t] : -1;
    const E* qp = reinterpret_cast<const E*>(a.q) + (long long)t * a.ldq
                  + (long long)(h * rep + r) * D;
    for (int c = lane; c < D; c += 32) {
      float x = live[i] ? to_f(qp[c]) : 0.f;
      if (live[i] && a.cos2) {
        // x * cos2 + rotate_half(x) * sin2, rounded as the plain version
        // rounds it (no fused multiply-add)
        const float xo = to_f(qp[c < D / 2 ? c + D / 2 : c - D / 2]);
        x = __fadd_rn(__fmul_rn(x, a.cos2[t * D + c]),
                      __fmul_rn(xo, a.sin2[t * D + c]));
      }
      qs[warp * R + i][c] = x;
    }
  }
  const long long st = a.start[0];

  float m[R], l[R], acc[R][C];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
  }

  const int s_begin = blockIdx.x * a.chunk;
  const int s_end = min(a.S, s_begin + a.chunk);
  for (int s0 = s_begin; s0 < s_end; s0 += kKeys) {
    __syncthreads();                              // the previous tile is consumed
    for (int e = threadIdx.x; e < kKeys * (D / V16); e += kThreads) {
      const int j = e / (D / V16);
      const int c = (e % (D / V16)) * V16;
      const int s = s0 + j;
      float kv[V16], vv[V16];
      if (s < s_end) {
        const long long off = ((long long)s * a.Hkv + h) * D + c;
        load16(K + off, kv);
        load16(V + off, vv);
      } else {                                    // zeros past the chunk
#pragma unroll
        for (int u = 0; u < V16; ++u) kv[u] = vv[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < V16; u += 4) {
        *reinterpret_cast<float4*>(&ks[j][c + u]) = make_float4(kv[u], kv[u + 1], kv[u + 2], kv[u + 3]);
        *reinterpret_cast<float4*>(&vs[j][c + u]) = make_float4(vv[u], vv[u + 1], vv[u + 2], vv[u + 3]);
      }
    }
    __syncthreads();
    if (!live[0]) continue;                       // rows fill warps in order

    // scores: lane = key; each key row is read once for the warp's rows,
    // and every row sums its d products in order
    const int s = s0 + lane;
    float sc[R];
#pragma unroll
    for (int i = 0; i < R; ++i) sc[i] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; c += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&ks[lane][c]);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(&qs[warp * R + i][c]);
        sc[i] = fmaf(q4.x, k4.x, sc[i]);
        sc[i] = fmaf(q4.y, k4.y, sc[i]);
        sc[i] = fmaf(q4.z, k4.z, sc[i]);
        sc[i] = fmaf(q4.w, k4.w, sc[i]);
      }
    }
    float pr[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool valid = s < s_end && s <= qi[i] && s >= st;
      float x = sc[i] * a.scale;
      if (a.bias) {
        const int j = s - a.kv_length;
        if (j >= 0 && j < a.T) x = x + a.bias[t_of[i] * a.T + j];
      }
      x = valid ? x : kNeg;
      float mt = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      // an explicit zero at invalid keys: a row with no valid key yet keeps
      // m == -1e30, where exp(x - m) would be 1
      const float p = valid ? expf(x - m_new) : 0.f;
      float ps = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
      pr[i] = round_as(p, E());
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    // PV: key j's value row is read once for the warp's rows
#pragma unroll 4
    for (int j = 0; j < kKeys; ++j) {
      float vj[C];
#pragma unroll
      for (int c = 0; c < C; ++c) vj[c] = vs[j][lane + 32 * c];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pj = __shfl_sync(0xffffffffu, pr[i], j);
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(pj, vj[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (!live[i]) continue;
    const int row = blockIdx.y * kRows + warp * R + i;
    const long long base = ((long long)blockIdx.x * a.Hkv + h) * rT + row;
#pragma unroll
    for (int c = 0; c < C; ++c) a.ws_acc[base * D + lane + 32 * c] = acc[i][c];
    if (lane == 0) {
      a.ws_ml[base * 2] = m[i];
      a.ws_ml[base * 2 + 1] = l[i];
    }
  }
}

// Combine the chunks of row blockIdx.x of kv head blockIdx.y in chunk order;
// thread c owns output dim c.
template <int D, typename E>
__global__ void __launch_bounds__(D) flash_combine_kernel(const Args a, int n_chunks) {
  const int row = blockIdx.x;
  const int h = blockIdx.y;
  const int c = threadIdx.x;
  const int rep = a.H / a.Hkv;
  const int rT = rep * a.T;
  float M = kNeg;
  for (int z = 0; z < n_chunks; ++z) {
    M = fmaxf(M, a.ws_ml[(((long long)z * a.Hkv + h) * rT + row) * 2]);
  }
  float L = 0.f, A = 0.f;
  for (int z = 0; z < n_chunks; ++z) {
    const long long base = ((long long)z * a.Hkv + h) * rT + row;
    const float w = expf(a.ws_ml[base * 2] - M);
    L = L + a.ws_ml[base * 2 + 1] * w;
    A = A + a.ws_acc[base * D + c] * w;
  }
  const int r = row / a.T;
  const int t = row % a.T;
  E* o = reinterpret_cast<E*>(a.out) + ((long long)t * a.H + h * rep + r) * D + c;
  store(o, A / fmaxf(L, 1e-30f));
}

template <int D, typename E>
int launch(const Args& a, cudaStream_t s) {
  const int rT = (a.H / a.Hkv) * a.T;
  const int n_chunks = (a.S + a.chunk - 1) / a.chunk;
  const dim3 grid1(n_chunks, (rT + kRows - 1) / kRows, a.Hkv);
  flash_partial_kernel<D, E><<<grid1, kThreads, 0, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  flash_combine_kernel<D, E><<<dim3(rT, a.Hkv), D, 0, s>>>(a, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// out[T, H, d] = attention of q over the S cache slots (see the header).
// scale is d**-0.5 as the caller rounds it to f32. Workspaces ws_acc
// [n_chunks, Hkv, rep*T, d] and ws_ml [n_chunks, Hkv, rep*T, 2] f32 come
// from the caller, n_chunks = ceil(S / chunk). q, k, v and
// out share one dtype (bf16 when bf16 != 0, else f32). Returns 0, a CUDA
// error code from a launch, or kErrShape for a shape the kernel does not take.
extern "C" int hsd_flash_decode(const void* q, long long ldq, const void* k,
                                const void* v, int bf16, const void* q_index,
                                const void* start, int kv_length, const void* bias,
                                const void* cos2, const void* sin2, int T, int H,
                                int Hkv, int d, int S, int chunk, float scale,
                                void* ws_acc, void* ws_ml, void* out, void* stream) {
  if (T <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || chunk <= 0 || chunk % kKeys) return kErrShape;
  if (d != 64 && d != 128) return kErrShape;
  if ((cos2 == nullptr) != (sin2 == nullptr)) return kErrShape;
  if ((long long)(H / Hkv) * T > 65535) return kErrShape;   // grid rows
  if ((uintptr_t)k % 16 || (uintptr_t)v % 16) return kErrShape;   // 16-byte loads
  Args a;
  a.q = q; a.ldq = ldq; a.k = k; a.v = v;
  a.q_index = reinterpret_cast<const long long*>(q_index);
  a.start = reinterpret_cast<const long long*>(start);
  a.kv_length = kv_length;
  a.bias = reinterpret_cast<const float*>(bias);
  a.cos2 = reinterpret_cast<const float*>(cos2);
  a.sin2 = reinterpret_cast<const float*>(sin2);
  a.T = T; a.H = H; a.Hkv = Hkv; a.S = S; a.chunk = chunk;
  a.scale = scale;
  a.ws_acc = reinterpret_cast<float*>(ws_acc);
  a.ws_ml = reinterpret_cast<float*>(ws_ml);
  a.out = out;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (d == 64) {
    return bf16 ? launch<64, __nv_bfloat16>(a, s) : launch<64, float>(a, s);
  }
  return bf16 ? launch<128, __nv_bfloat16>(a, s) : launch<128, float>(a, s);
}

extern "C" const char* hsd_flash_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the flash-decode kernel";
  return cudaGetErrorString((cudaError_t)code);
}
