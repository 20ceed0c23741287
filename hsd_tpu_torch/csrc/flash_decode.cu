// Flash-decode attention (K8) for Hopper (sm_90a).
//
// Hand-written counterpart of the Pallas kernel `_kernel` in
// hsd_tpu/ops/flash_decode.py (:49, through `_flash_core`'s pallas_call at
// :166): one sequence's queries q [T, H, d] attend to one layer's cache
// buffers K, V [S, Hkv, d] with online softmax, GQA without a repeat of K/V
// (rep = H / Hkv query heads share a kv head), the index mask
// key_pos <= q_index[t] && key_pos >= start, an optional [T, T] additive bias
// on the slots [kv_length, kv_length + T) (tree attention) and an optional
// rotate-half RoPE of the raw queries, which then stay f32. Scores are scaled
// by d^-0.5, p is rounded to V's dtype before PV, a fully masked query row
// gives zeros (acc / max(l, 1e-30) with l == 0), and the output takes q's
// dtype. d is 64 or 128, T at most 128, one sequence.
//
// Bound on the card: the K and V bytes of the S slots, read once (14B at
// S = 4192: 17.2 MB, 5.1 us at 3.35 TB/s). The operations, 4 T H S d, are
// about rep T per byte, at most ~64 at the decode shapes and ~256 at an
// EAGLE tree: below the ~295 where the bf16 tensor cores would bound it.
//
// A TPU grid walks S in order and carries (max, denominator, accumulator)
// in VMEM; blocks of a Hopper grid run in no order, and batch 1 has only
// Hkv kv heads, so S is split into chunks whose size depends on S, Hkv and
// d alone (ops/flash_decode.chunk_for), never on T.
//
// bf16 K/V (every model): flash_tc_kernel, one launch. A block owns one kv
// head, one chunk and a tile of up to 64 of the head's rep T query rows (row
// r T + t is query t of head h rep + r), so at every decode shape a chunk's
// K and V are read once. K and V stay bf16: 64-key tiles of both come
// through a three-stage ring of 16-byte cp.async copies (rows padded by 16
// bytes, so ldmatrix is free of bank conflicts; slots past S zero-filled),
// issued by the warps whose row groups hold no rows where there are such.
// Eight warps: four row groups (one m16 tile of rows each) times two key
// slices (32 keys of every tile each), so a decode step's one row group
// still runs two warps. Scores Q K^T and PV run on
// mma.sync m16n8k16 bf16 -> f32: K's B fragments by ldmatrix, V's by
// ldmatrix.trans, q's A fragments by ldmatrix from a staged copy. bf16 q is
// one plane; the RoPE form rotates the raw q in f32 (__fmul_rn /
// __fadd_rn, no FMA) and splits it into three exact bf16 planes hi, mid, lo
// (hi + mid + lo == q), three mma a k-step, so the f32 q keeps its bits as
// K1/K3/K4/K5 keep their f32 operands. Scale, bias and mask are applied in
// registers; a row's max and sum run over its quad; invalid keys get an
// explicit p = 0 (a row with no valid key yet keeps m = -1e30); exp is
// ex2.approx of (x - m) log2 e; p rounds to bf16 in registers and is the A
// fragment of PV. A warp's online softmax
// runs over its slice's keys; at the chunk's end the two slices of a row
// group merge in slice order through shared memory. The chunks of one (kv
// head, row tile) form one thread-block cluster (at most 16 chunks): each
// block leaves its rows' (m, l, acc) in its shared memory, and after a
// cluster barrier every block combines a share of the output, reading the
// chunks' partials through distributed shared memory in chunk order. No
// workspace, no atomics, and a row's arithmetic never depends on the other
// rows: its bits are the same at any T and at any place in an m16 tile.
//
// f32 K/V (f32 test models only): flash_partial_kernel + flash_combine_kernel,
// the first CUDA-core design, unchanged. Pass 1: a block owns one kv head, up to
// 16 query rows (two per warp) and one chunk; it stages the chunk's keys and
// values in shared memory 32 at a time with 16-byte loads, and each warp runs
// the online softmax of its two rows over them in f32 (one key per lane; the
// dot products on the CUDA cores). Pass 2 combines the chunks of each row in
// chunk order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// ---------------------------------------------------------------------------
// f32 K/V: the CUDA-core kernels.

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

// 16 bytes of a K or V row (4 f32 values)
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
}

// p cast to V's dtype before the PV product
__device__ __forceinline__ float round_as(float x, float) { return x; }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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

// ---------------------------------------------------------------------------
// bf16 K/V: the tensor-core kernel.

constexpr int kRowGroups = 4;                  // m16 row tiles a block
constexpr int kKeySlices = 2;                  // warps sharing a row tile, by keys
constexpr int kTcWarps = kRowGroups * kKeySlices;
constexpr int kTcThreads = kTcWarps * 32;
constexpr int kTileRows = kRowGroups * 16;     // query rows per block
constexpr int kTileKeys = 64;                  // keys per staged tile
constexpr int kSliceKeys = kTileKeys / kKeySlices;   // a warp's keys of a tile
constexpr int kStages = 3;                     // cp.async ring depth
constexpr int kRowPad = 8;                     // bf16 past d in a staged row
constexpr int kMaxChunks = 16;                 // chunks a cluster: the H100's largest cluster
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  const __nv_bfloat16* q;
  long long ldq;            // elements between query rows t and t+1
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const long long* q_index; // [T]
  const long long* start;   // [1]
  int kv_length;
  const float* bias;        // [T, T] or null
  const float* cos2;        // [T, d] or null (then q is already rotated)
  const float* sin2;
  int T, H, Hkv, S;
  int chunk;                // keys per chunk, a multiple of kTileKeys
  float scale;
  __nv_bfloat16* out;       // [T, H, d]
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Grid (chunk, kv head, row tile). NP: the planes of q, 1 (bf16 q) or 3 (the
// RoPE form's f32 q).
template <int D, int NP>
__global__ void __launch_bounds__(kTcThreads) flash_tc_kernel(const TcArgs a) {
  constexpr int LD = D + kRowPad;              // a staged row, in bf16
  constexpr int CPR = D / 8;                   // 16-byte copies a row
  constexpr int DT = D / 8;                    // output n-tiles
  constexpr int KN = kSliceKeys / 8;           // score n-tiles of a warp's keys
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);  // [stage][K, V][key][LD]
  __nv_bfloat16* qs = ring + kStages * 2 * kTileKeys * LD;      // [plane][row][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;                     // the thread's rows g, g + 8 ...
  const int qd = lane & 3;                     // ... and its columns 2 qd, 2 qd + 1
  const int z = blockIdx.x;
  const int h = blockIdx.y;
  const int rep = a.H / a.Hkv;
  const int rT = rep * a.T;
  const int row0 = blockIdx.z * kTileRows;
  const int s_begin = z * a.chunk;
  const int s_end = min(a.S, s_begin + a.chunk);
  const int n_tiles = (s_end - s_begin + kTileKeys - 1) / kTileKeys;

  // tile i's keys and values into ring stage i % kStages, copied by the
  // warps of the row groups that hold no rows (all warps when every group
  // holds some), so a decode step's computing warps issue no copies; always
  // one commit group, so the waits count tiles
  const int groups = min(kRowGroups, (rT - row0 + 15) / 16);
  const int copier0 = groups < kRowGroups ? groups * kKeySlices * 32 : 0;
  auto stage = [&](int i) {
    if (i < n_tiles && tid >= copier0) {
      __nv_bfloat16* kd = ring + (i % kStages) * 2 * kTileKeys * LD;
      __nv_bfloat16* vd = kd + kTileKeys * LD;
      const int s0 = s_begin + i * kTileKeys;
      for (int e = tid - copier0; e < kTileKeys * CPR; e += kTcThreads - copier0) {
        const int j = e / CPR;
        const int c = (e % CPR) * 8;
        const bool in = s0 + j < s_end;       // zeros past the chunk
        const long long off = in ? ((long long)(s0 + j) * a.Hkv + h) * D + c : 0;
        cp_async16(kd + j * LD + c, a.k + off, in ? 16 : 0);
        cp_async16(vd + j * LD + c, a.v + off, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  // the tile's query rows, bf16 as stored, zero past rT: one copy group
  // ahead of the first tiles' (for the RoPE form into the lo plane, which the
  // rotation below reads and overwrites)
  __nv_bfloat16* qraw = qs + (NP - 1) * kTileRows * LD;
  for (int e = tid; e < kTileRows * CPR; e += kTcThreads) {
    const int i = e / CPR;
    const int c = (e % CPR) * 8;
    const int row = row0 + i;
    const __nv_bfloat16* src = a.q;
    if (row < rT) {
      src += (long long)(row % a.T) * a.ldq + (long long)(h * rep + row / a.T) * D + c;
    }
    cp_async16(qraw + i * LD + c, src, row < rT ? 16 : 0);
  }
  cp_async_commit();
  for (int i = 0; i < kStages - 1; ++i) stage(i);

  if constexpr (NP == 3) {
    // rotate-half RoPE in f32, x * cos2 + rotate_half(x) * sin2 rounded as
    // the plain version rounds it (no fused multiply-add), then the exact
    // split into hi, mid and lo. A thread owns dims [c, c + 8) and their
    // partners [c + D/2, c + D/2 + 8) of a row, so it reads and overwrites
    // only its own raw values.
    cp_async_wait<kStages - 1>();
    __syncthreads();
    for (int e = tid; e < kTileRows * (D / 16); e += kTcThreads) {
      const int i = e / (D / 16);
      const int c = (e % (D / 16)) * 8;
      const int row = row0 + i;
      const int t = row < rT ? row % a.T : 0;   // padded rows: zeros, any table row
      float x[2][8], cs[2][8], sn[2][8];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int cc = c + half * (D / 2);
        const uint4 raw = *reinterpret_cast<const uint4*>(qraw + i * LD + cc);
        const uint32_t* pr = reinterpret_cast<const uint32_t*>(&raw);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          x[half][2 * u] = __uint_as_float(pr[u] << 16);
          x[half][2 * u + 1] = __uint_as_float(pr[u] & 0xffff0000u);
        }
#pragma unroll
        for (int u = 0; u < 8; u += 4) {
          const float4 cv = __ldg(reinterpret_cast<const float4*>(a.cos2 + t * D + cc + u));
          const float4 sv = __ldg(reinterpret_cast<const float4*>(a.sin2 + t * D + cc + u));
          cs[half][u] = cv.x; cs[half][u + 1] = cv.y; cs[half][u + 2] = cv.z; cs[half][u + 3] = cv.w;
          sn[half][u] = sv.x; sn[half][u + 1] = sv.y; sn[half][u + 2] = sv.z; sn[half][u + 3] = sv.w;
        }
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t ph[4], pm[4], pl[4];
#pragma unroll
        for (int u = 0; u < 8; u += 2) {
          float y[2], r1[2], r2[2];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
            y[w] = __fadd_rn(__fmul_rn(x[half][u + w], cs[half][u + w]),
                             __fmul_rn(x[1 - half][u + w], sn[half][u + w]));
            r1[w] = __fsub_rn(y[w], __bfloat162float(__float2bfloat16_rn(y[w])));
            r2[w] = __fsub_rn(r1[w], __bfloat162float(__float2bfloat16_rn(r1[w])));
          }
          ph[u / 2] = pack_bf16(y[0], y[1]);
          pm[u / 2] = pack_bf16(r1[0], r1[1]);
          pl[u / 2] = pack_bf16(r2[0], r2[1]);
        }
        const int o = i * LD + c + half * (D / 2);
        *reinterpret_cast<uint4*>(qs + o) = make_uint4(ph[0], ph[1], ph[2], ph[3]);
        *reinterpret_cast<uint4*>(qs + kTileRows * LD + o) = make_uint4(pm[0], pm[1], pm[2], pm[3]);
        *reinterpret_cast<uint4*>(qs + 2 * kTileRows * LD + o) = make_uint4(pl[0], pl[1], pl[2], pl[3]);
      }
    }
  }

  // warp (row group rg, key slice ks) owns rows [16 rg, 16 rg + 16) of the
  // tile and keys [32 ks, 32 ks + 32) of every key tile; its thread's rows
  // g and g + 8 take the keys s with lo[ri] <= s <= hi[ri] (padded rows
  // none), and their bias row
  const int rg = warp / kKeySlices;
  const int ks = warp % kKeySlices;
  const int wrow = rg * 16;
  const bool busy = row0 + wrow < rT;          // rows fill row groups in order
  const long long st = a.start[0];
  int lo[2], hi[2], tq[2];
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int row = row0 + wrow + g + 8 * ri;
    tq[ri] = row < rT ? row % a.T : 0;
    const long long qi = row < rT ? a.q_index[tq[ri]] : -1;
    hi[ri] = (int)min(qi, (long long)s_end - 1);
    lo[ri] = (int)min(max(st, (long long)s_begin), (long long)s_end);
  }

  float m[2] = {kNeg, kNeg};
  float l[2] = {0.f, 0.f};
  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                            // tile i landed; tile i - 1 consumed
    stage(i + kStages - 1);
    if (!busy) continue;
    const __nv_bfloat16* kt = ring + (i % kStages) * 2 * kTileKeys * LD + ks * kSliceKeys * LD;
    const __nv_bfloat16* vt = kt + kTileKeys * LD;
    const int s0 = s_begin + i * kTileKeys + ks * kSliceKeys;

    // scores of the warp's keys: the k16 steps in order, q's planes hi,
    // mid, lo in each
    float sc[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[NP][4];
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        ldmatrix_x4(qa[p], qs + (p * kTileRows + wrow + (lane & 15)) * LD + kk * 16
                               + (lane >> 4) * 8);
      }
#pragma unroll
      for (int nn = 0; nn < KN / 2; ++nn) {
        uint32_t kb[4];
        ldmatrix_x4(kb, kt + (nn * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16
                            + (lane & 8));
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          mma_bf16(sc[2 * nn], qa[p], kb[0], kb[1]);
          mma_bf16(sc[2 * nn + 1], qa[p], kb[2], kb[3]);
        }
      }
    }

    // scale, bias, mask; the rows' maxima over the quad
    float mt[2] = {kNeg, kNeg};
    bool ok[KN][4];
#pragma unroll
    for (int n = 0; n < KN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const int s = s0 + 8 * n + 2 * qd + (e & 1);
        ok[n][e] = s >= lo[ri] && s <= hi[ri];
        float x = __fmul_rn(sc[n][e], a.scale);
        if (a.bias) {
          const int j = s - a.kv_length;
          if (j >= 0 && j < a.T) x = __fadd_rn(x, a.bias[tq[ri] * a.T + j]);
        }
        sc[n][e] = ok[n][e] ? x : kNeg;
        mt[ri] = fmaxf(mt[ri], sc[n][e]);
      }
    }
    float mn[2], alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mt[ri] = fmaxf(mt[ri], __shfl_xor_sync(0xffffffffu, mt[ri], 1));
      mt[ri] = fmaxf(mt[ri], __shfl_xor_sync(0xffffffffu, mt[ri], 2));
      mn[ri] = fmaxf(m[ri], mt[ri]);
      alpha[ri] = ex2(__fmul_rn(m[ri] - mn[ri], kLog2e));
    }
    // an explicit zero at invalid keys: a row with no valid key yet keeps
    // m == -1e30, where exp(x - m) would be 1
#pragma unroll
    for (int n = 0; n < KN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = e >> 1;
        const float p = ok[n][e] ? ex2(__fmul_rn(sc[n][e] - mn[ri], kLog2e)) : 0.f;
        ps[ri] += p;
        sc[n][e] = p;
      }
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      ps[ri] += __shfl_xor_sync(0xffffffffu, ps[ri], 1);
      ps[ri] += __shfl_xor_sync(0xffffffffu, ps[ri], 2);
      l[ri] = fmaf(l[ri], alpha[ri], ps[ri]);
      m[ri] = mn[ri];
    }
    // acc *= alpha; alpha == 1 (the max did not move) is skipped, which
    // leaves the same bits
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }

    // PV: p rounded to bf16 is the A fragment, V's B fragments by
    // ldmatrix.trans, the warp's k16 steps in order
#pragma unroll
    for (int kk = 0; kk < KN / 2; ++kk) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kk][0], sc[2 * kk][1]),
                              pack_bf16(sc[2 * kk][2], sc[2 * kk][3]),
                              pack_bf16(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                              pack_bf16(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
      for (int nn = 0; nn < D / 16; ++nn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + (kk * 16 + (lane & 15)) * LD + nn * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * nn], pa, vb[0], vb[1]);
        mma_bf16(o[2 * nn + 1], pa, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                              // the ring is free

  // The key slices of a row group merge in slice order: slices 1.. leave
  // (m, l, acc) in the ring in their register layout, slice 0 takes
  // M = max m, then l = sum l w and acc = sum acc w, w = exp(m - M).
  static_assert(kRowGroups * (kKeySlices - 1) * (DT + 1) * 4 * 32 * 4
                    <= kStages * 2 * kTileKeys * LD * 2, "the merge fits the ring");
  float* mo = reinterpret_cast<float*>(smem);                       // [rg][ks-1][reg][lane]
  float* mml = mo + kRowGroups * (kKeySlices - 1) * DT * 4 * 32;   // [rg][ks-1][4][lane]
  if (busy && ks > 0) {
    const int slot = rg * (kKeySlices - 1) + ks - 1;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) mo[(slot * DT * 4 + n * 4 + e) * 32 + lane] = o[n][e];
    }
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      mml[(slot * 4 + ri) * 32 + lane] = m[ri];
      mml[(slot * 4 + 2 + ri) * 32 + lane] = l[ri];
    }
  }
  __syncthreads();
  if (busy && ks == 0) {
    float w[kKeySlices][2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float M = m[ri];
#pragma unroll
      for (int k2 = 1; k2 < kKeySlices; ++k2) {
        M = fmaxf(M, mml[((rg * (kKeySlices - 1) + k2 - 1) * 4 + ri) * 32 + lane]);
      }
      w[0][ri] = expf(m[ri] - M);
      float L = l[ri] * w[0][ri];
#pragma unroll
      for (int k2 = 1; k2 < kKeySlices; ++k2) {
        const int slot = rg * (kKeySlices - 1) + k2 - 1;
        w[k2][ri] = expf(mml[(slot * 4 + ri) * 32 + lane] - M);
        L = fmaf(mml[(slot * 4 + 2 + ri) * 32 + lane], w[k2][ri], L);
      }
      m[ri] = M;
      l[ri] = L;
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = o[n][e] * w[0][e >> 1];
#pragma unroll
        for (int k2 = 1; k2 < kKeySlices; ++k2) {
          const int slot = rg * (kKeySlices - 1) + k2 - 1;
          x = fmaf(mo[(slot * DT * 4 + n * 4 + e) * 32 + lane], w[k2][e >> 1], x);
        }
        o[n][e] = x;
      }
    }
  }

  // The chunks of one (kv head, row tile) are one thread-block cluster, rank
  // = chunk. Each block leaves its rows' (m, l, acc) in its own shared
  // memory; after the cluster barrier every block combines a share of the
  // output's float4 items, reading all the chunks' partials (distributed
  // shared memory) in chunk order: M = max m, w = exp(m - M), l = sum l w,
  // acc = sum acc w, out = acc / max(l, 1e-30).
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                              // the merge's reads are done
  float* pacc = reinterpret_cast<float*>(smem);                   // [row][D]
  float2* pml = reinterpret_cast<float2*>(pacc + kTileRows * D);  // [row]
  float* wz = reinterpret_cast<float*>(pml + kTileRows);          // [row][chunk]
  float* den = wz + kTileRows * kMaxChunks;                       // [row]
  if (busy && ks == 0) {
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      const int i = wrow + g + 8 * ri;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        *reinterpret_cast<float2*>(pacc + i * D + 8 * n + 2 * qd) =
            make_float2(o[n][2 * ri], o[n][2 * ri + 1]);
      }
      if (qd == 0) pml[i] = make_float2(m[ri], l[ri]);
    }
  }
  cluster.sync();
  const int nz = gridDim.x;
  const int nrows = min(kTileRows, rT - row0);
  if (tid < nrows) {
    float2 ml[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nz) ml[c] = cluster.map_shared_rank(pml, c)[tid];
    }
    float M = kNeg;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nz) M = fmaxf(M, ml[c].x);
    }
    float L = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nz) {
        const float w = expf(ml[c].x - M);
        L = fmaf(ml[c].y, w, L);
        wz[tid * kMaxChunks + c] = w;
      }
    }
    den[tid] = fmaxf(L, 1e-30f);
  }
  __syncthreads();
  const int items = nrows * (D / 4);
  const int per = (items + nz - 1) / nz;
  const int e_end = min(items, (z + 1) * per);
  for (int e = z * per + tid; e < e_end; e += kTcThreads) {
    const int i = e / (D / 4);
    const int c4 = (e % (D / 4)) * 4;
    float4 x[kMaxChunks];
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nz) x[c] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pacc, c) + i * D + c4);
    }
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < kMaxChunks; ++c) {
      if (c < nz) {
        const float w = wz[i * kMaxChunks + c];
        acc.x = fmaf(x[c].x, w, acc.x);
        acc.y = fmaf(x[c].y, w, acc.y);
        acc.z = fmaf(x[c].z, w, acc.z);
        acc.w = fmaf(x[c].w, w, acc.w);
      }
    }
    const int row = row0 + i;
    const int r = row / a.T;
    const int t = row % a.T;
    const float dn = den[i];
    *reinterpret_cast<uint2*>(a.out + ((long long)t * a.H + h * rep + r) * D + c4) =
        make_uint2(pack_bf16(acc.x / dn, acc.y / dn), pack_bf16(acc.z / dn, acc.w / dn));
  }
  cluster.sync();                               // the partials stay until all are read
}

template <int D, int NP>
int launch_tc(const TcArgs& a, int row_tiles, cudaStream_t s) {
  constexpr int smem = (kStages * 2 * kTileKeys + NP * kTileRows) * (D + kRowPad) * 2;
  static bool configured = false;        // the opt-ins, once
  if (!configured) {
    int err = (int)cudaFuncSetAttribute(flash_tc_kernel<D, NP>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (!err) {
      err = (int)cudaFuncSetAttribute(flash_tc_kernel<D, NP>,
                                      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    if (err) return err;
    configured = true;
  }
  const int n_chunks = (a.S + a.chunk - 1) / a.chunk;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, a.Hkv, row_tiles);
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_chunks;          // the chunks of a (kv head, row tile)
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int err = (int)cudaLaunchKernelEx(&cfg, flash_tc_kernel<D, NP>, a);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// out[T, H, d] = attention of q over the S cache slots (see the header).
// scale is d**-0.5 as the caller rounds it to f32; chunk is the keys per
// chunk (ops/flash_decode.chunk_for), n_chunks = ceil(S / chunk). q, k, v and
// out share one dtype (bf16 when bf16 != 0, else f32). ws: with f32, a
// workspace of n_chunks * Hkv * rep*T * (d + 2) f32, the accumulators then
// (max, denominator) pairs; with bf16 unused (may be null). Returns 0, a CUDA
// error code from a launch, or kErrShape for a shape the kernels do not take.
extern "C" int hsd_flash_decode(const void* q, long long ldq, const void* k,
                                const void* v, int bf16, const void* q_index,
                                const void* start, int kv_length, const void* bias,
                                const void* cos2, const void* sin2, int T, int H,
                                int Hkv, int d, int S, int chunk, float scale,
                                void* ws, void* out, void* stream) {
  if (T <= 0 || Hkv <= 0 || H % Hkv || S <= 0 || chunk <= 0) return kErrShape;
  if (d != 64 && d != 128) return kErrShape;
  if ((cos2 == nullptr) != (sin2 == nullptr)) return kErrShape;
  if ((uintptr_t)k % 16 || (uintptr_t)v % 16) return kErrShape;   // 16-byte copies
  const long long rT = (long long)(H / Hkv) * T;
  const long long n_chunks = (S + chunk - 1) / chunk;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16) {
    const long long row_tiles = (rT + kTileRows - 1) / kTileRows;
    if (chunk % kTileKeys || n_chunks > kMaxChunks) return kErrShape;
    if (Hkv > 65535 || row_tiles > 65535) return kErrShape;          // grid
    if ((uintptr_t)q % 16 || ldq % 8) return kErrShape;              // 16-byte copies
    if ((uintptr_t)cos2 % 16 || (uintptr_t)sin2 % 16) return kErrShape;
    TcArgs a;
    a.q = reinterpret_cast<const __nv_bfloat16*>(q);
    a.ldq = ldq;
    a.k = reinterpret_cast<const __nv_bfloat16*>(k);
    a.v = reinterpret_cast<const __nv_bfloat16*>(v);
    a.q_index = reinterpret_cast<const long long*>(q_index);
    a.start = reinterpret_cast<const long long*>(start);
    a.kv_length = kv_length;
    a.bias = reinterpret_cast<const float*>(bias);
    a.cos2 = reinterpret_cast<const float*>(cos2);
    a.sin2 = reinterpret_cast<const float*>(sin2);
    a.T = T; a.H = H; a.Hkv = Hkv; a.S = S; a.chunk = chunk;
    a.scale = scale;
    a.out = reinterpret_cast<__nv_bfloat16*>(out);
    const int rt = (int)row_tiles;
    if (d == 64) return cos2 ? launch_tc<64, 3>(a, rt, s) : launch_tc<64, 1>(a, rt, s);
    return cos2 ? launch_tc<128, 3>(a, rt, s) : launch_tc<128, 1>(a, rt, s);
  }
  if (chunk % kKeys || !ws) return kErrShape;
  if (rT > 65535) return kErrShape;                                // grid rows
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
  a.ws_acc = reinterpret_cast<float*>(ws);
  a.ws_ml = a.ws_acc + n_chunks * Hkv * rT * d;
  a.out = out;
  if (d == 64) return launch<64, float>(a, s);
  return launch<128, float>(a, s);
}

extern "C" const char* hsd_flash_error_string(int code) {
  if (code == kErrShape) return "shape not supported by the flash-decode kernel";
  return cudaGetErrorString((cudaError_t)code);
}
