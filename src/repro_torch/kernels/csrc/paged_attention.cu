// Paged decode attention for Hopper (sm_90a), behind a plain C function that
// Python loads with ctypes (src/repro_torch/kernels/build.py builds it).
//
// Replaces src/repro/kernels/paged_attention.py:74 `paged_attention`, the
// Pallas TPU kernel `_pa_kernel`: one query token per row attends over keys
// and values read through a block table, with an online softmax in float32
// (running max, running sum, accumulator), the mask `c*bs + o >= len` with
// NEG_INF = -1e30 and the denominator clamped at 1e-30. GQA: query head h
// reads kv head h / (Hq / Hkv). The output has q's type.
//
// What bounds it on an H100: the K/V bytes. Each (row, kv head) reads
// ceil(len / bs) blocks of bs x D keys and values and does about four
// operations per element read, far below the roughly 295 operations per byte
// at which the tensor cores, not the memory, would set the limit. So the
// design reads every needed K/V element from device memory once, and keeps
// several of those reads in flight:
//   * one CUDA block per (row b, kv head) serves all g = Hq / Hkv query heads
//     that share that kv head, so GQA does not read K/V g times;
//   * the block loads its own table entries and length (in place of the
//     TPU's scalar prefetch) and stops after ceil(len / bs) columns, so the
//     power-of-two padding columns (the zero block) are never read. Stopping
//     there is exact: a fully masked column adds exp(-1e30 - m) = 0 to the sum
//     and leaves the running max as it was;
//   * each column's K and V tiles are copied to shared memory with 16-byte
//     cp.async copies, STAGES - 1 columns ahead of the one being computed (a
//     ring of STAGES tiles), so the copies of later columns overlap the math
//     of this one instead of waiting one device-memory latency per load;
//   * with 8 warps: scores take a warp per four (head, offset) pairs, reduced
//     together, the softmax update a warp per head, the PV product a thread
//     per (head, dim); one block per SM has few warps to hide latency with,
//     so each stage keeps several independent chains in flight.
// Left for later work: several blocks per (row, kv head) on long contexts
// (split over columns, then a pass that merges), TMA bulk copies.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kPairs = 4;  // (head, offset) score pairs a warp takes at once
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 227 * 1024;  // dynamic shared memory per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// shared memory layout, in bytes, shared by the kernel and its launcher
struct Smem {
  size_t tile, kv, q, acc, p, stats, total;
  __host__ __device__ Smem(int g, int D, int bs, int stages, size_t elem) {
    tile = (size_t)bs * D * elem;           // one K (or V) tile
    kv = 0;                                 // K ring, then V ring
    q = kv + 2 * (size_t)stages * tile;     // g * D float, pre-scaled
    acc = q + sizeof(float) * g * D;        // g * D float accumulator
    p = acc + sizeof(float) * g * D;        // g * bs float scores / probs
    stats = p + sizeof(float) * g * bs;     // g x (max, sum, correction)
    total = stats + sizeof(float) * 3 * g;
  }
};

// q: (B, Hq, D); k_pool, v_pool: (n_blocks, bs, Hkv, D); table: (B, n_cols);
// seq_lens: (B,); out: (B, Hq, D). All contiguous; pools 16-byte aligned with
// D * sizeof(T) a multiple of 16. Grid (Hkv, B).
template <typename T, int STAGES>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool,
    const T* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ seq_lens, T* __restrict__ out, int Hq, int Hkv,
    int D, int bs, int n_cols, int n_blocks, float scale) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = Hq / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const Smem lay(g, D, bs, STAGES, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_ring = reinterpret_cast<T*>(smem + lay.kv);
  T* v_ring = k_ring + (size_t)STAGES * bs * D;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  float* acc_s = reinterpret_cast<float*>(smem + lay.acc);
  float* p_s = reinterpret_cast<float*>(smem + lay.p);
  float* m_s = reinterpret_cast<float*>(smem + lay.stats);
  float* l_s = m_s + g;
  float* c_s = l_s + g;

  const int len = seq_lens[b];
  const int n_valid = min(n_cols, (len + bs - 1) / bs);
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * g;
  for (int i = tid; i < g * D; i += blockDim.x) {
    q_s[i] = to_f32(q[head0 * D + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int h = tid; h < g; h += blockDim.x) {
    m_s[h] = kNegInf;
    l_s[h] = 0.f;
  }

  // async copy of column c's K and V tiles into ring slot `slot`
  const size_t slot_stride = (size_t)Hkv * D;  // elements between offsets
  const int row_chunks = D * (int)sizeof(T) / 16;
  const int n_chunks = bs * row_chunks;
  auto copy_tile = [&](int c, int slot) {
    const int bid = table[(size_t)b * n_cols + c];
    if (bid < 0 || bid >= n_blocks) __trap();  // a table entry off the pool
    const size_t base = (size_t)bid * bs * slot_stride + (size_t)kvh * D;
    const char* ks = reinterpret_cast<const char*>(k_pool + base);
    const char* vs = reinterpret_cast<const char*>(v_pool + base);
    char* kd = reinterpret_cast<char*>(k_ring + (size_t)slot * bs * D);
    char* vd = reinterpret_cast<char*>(v_ring + (size_t)slot * bs * D);
    for (int i = tid; i < n_chunks; i += blockDim.x) {
      const int o = i / row_chunks;
      const size_t src = (o * slot_stride) * sizeof(T) +
                         (size_t)(i - o * row_chunks) * 16;
      cp_async16(kd + (size_t)i * 16, ks + src);
      cp_async16(vd + (size_t)i * 16, vs + src);
    }
  };

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n_valid) copy_tile(s, s);
    cp_async_commit();
  }
  for (int c = 0; c < n_valid; ++c) {
    // slot (c - 1) % STAGES was last read in iteration c - 1, before its
    // closing barrier, so it can take column c + STAGES - 1 now
    const int ahead = c + STAGES - 1;
    if (ahead < n_valid) copy_tile(ahead, ahead % STAGES);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // column c's group has landed
    __syncthreads();
    const T* k_s = k_ring + (size_t)(c % STAGES) * bs * D;
    const T* v_s = v_ring + (size_t)(c % STAGES) * bs * D;

    // scores: each warp takes kPairs (head, offset) pairs at once, lanes
    // split D, and the kPairs sums are shuffle-reduced together so their
    // latencies overlap (a pair past g * bs repeats the last and is dropped)
    for (int p0 = warp * kPairs; p0 < g * bs; p0 += n_warps * kPairs) {
      int q_off[kPairs], k_off[kPairs];
      float s[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        const int pair = min(p0 + j, g * bs - 1);
        const int h = pair / bs;
        q_off[j] = h * D;
        k_off[j] = (pair - h * bs) * D;
        s[j] = 0.f;
      }
      for (int d = lane; d < D; d += 32) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j)
          s[j] += q_s[q_off[j] + d] * to_f32(k_s[k_off[j] + d]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j)
          s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
      }
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const int pair = p0 + j;
          if (pair < g * bs)
            p_s[pair] = (c * bs + pair % bs < len) ? s[j] : kNegInf;
        }
      }
    }
    __syncthreads();

    // online-softmax update: one warp per head, lanes split the offsets
    for (int h = warp; h < g; h += n_warps) {
      float* p = p_s + h * bs;
      const float m_prev = m_s[h];
      float m_col = kNegInf;
      for (int o = lane; o < bs; o += 32) m_col = fmaxf(m_col, p[o]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_col = fmaxf(m_col, __shfl_xor_sync(0xffffffffu, m_col, off));
      const float m_new = fmaxf(m_prev, m_col);
      float sum = 0.f;
      for (int o = lane; o < bs; o += 32) {
        p[o] = expf(p[o] - m_new);
        sum += p[o];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[h] = l_s[h] * corr + sum;
        m_s[h] = m_new;
        c_s[h] = corr;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * D; i += blockDim.x) {
      const int h = i / D;
      const int d = i - h * D;
      const float* p = p_s + h * bs;
      float a = acc_s[i] * c_s[h];
      for (int o = 0; o < bs; ++o) a += p[o] * to_f32(v_s[o * D + d]);
      acc_s[i] = a;
    }
    __syncthreads();  // this slot and p_s are rewritten next iteration
  }
  cp_async_wait<0>();  // no copy may outlive the block
  __syncthreads();     // l_s is read across threads (also when n_valid = 0)

  for (int i = tid; i < g * D; i += blockDim.x) {
    out[head0 * D + i] = from_f32<T>(acc_s[i] / fmaxf(l_s[i / D], 1e-30f));
  }
}

template <typename T, int STAGES>
cudaError_t launch_stages(const void* q, const void* k_pool,
                          const void* v_pool, const void* table,
                          const void* seq_lens, void* out, int B, int Hq,
                          int Hkv, int D, int bs, int n_cols, int n_blocks,
                          float scale, size_t smem, cudaStream_t stream) {
  auto kernel = paged_attention_kernel<T, STAGES>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(table),
      static_cast<const int*>(seq_lens), static_cast<T*>(out), Hq, Hkv, D, bs,
      n_cols, n_blocks, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* table, const void* seq_lens, void* out, int B, int Hq,
           int Hkv, int D, int bs, int n_cols, int n_blocks, float scale,
           cudaStream_t stream) {
  const int g = Hq / Hkv;
  if ((D * sizeof(T)) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k_pool) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v_pool) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  // the deepest ring of tiles that fits in shared memory
  int stages = kMaxStages;
  while (stages > 1 && Smem(g, D, bs, stages, sizeof(T)).total > kMaxSmem)
    --stages;
  const size_t smem = Smem(g, D, bs, stages, sizeof(T)).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidConfiguration;
#define PA_ARGS                                                             \
  q, k_pool, v_pool, table, seq_lens, out, B, Hq, Hkv, D, bs, n_cols,       \
      n_blocks, scale, smem, stream
  switch (stages) {
    case 4: return (int)launch_stages<T, 4>(PA_ARGS);
    case 3: return (int)launch_stages<T, 3>(PA_ARGS);
    case 2: return (int)launch_stages<T, 2>(PA_ARGS);
    default: return (int)launch_stages<T, 1>(PA_ARGS);
  }
#undef PA_ARGS
}

}  // namespace

extern "C" {

// Launches on `stream` and returns the launch's cudaError_t (0 = queued).
// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* seq_lens, void* out, int B, int Hq,
                           int Hkv, int D, int bs, int n_cols, int n_blocks,
                           float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_pool, v_pool, table, seq_lens, out, B, Hq, Hkv,
                         D, bs, n_cols, n_blocks, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, table, seq_lens, out, B,
                                 Hq, Hkv, D, bs, n_cols, n_blocks, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
