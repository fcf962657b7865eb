// Bucketed lexicographic segment min for Hopper (sm_90a).
//
// For each bucket b and local vertex v < vb, the lexicographic minimum of
//     (cand[b, e], lab[b, e], src[b, e])
// over the bucket's edges e with ldst[b, e] == v.  A lane whose candidate is
// not finite is inert; a vertex with no finite lane gets (+inf, IMAX, IMAX).
// cand is f32 or bf16 (upcast to f32), ids are int32; outputs are (NB, vb)
// f32 / i32 / i32.  Inputs must hold no NaN and no -inf (the same contract as
// the min-plus kernels), and ldst must lie in [0, vb): an edge outside is
// ignored, as the TPU kernel's compare mask ignores it.
//
// segmin_bucketed  replaces src/repro/kernels/segmin/segmin.py
//   segmin_bucketed_call (Pallas body _kernel).
//   Bound: device-memory bytes.  A call must read cand/ldst/lab/src (16 B an
//   edge) and write 12 B a bucket vertex; it does ~10 integer operations an
//   edge, far below the card's rate.
//   Design: the TPU kernel compared every edge of a tile with every vertex
//   of the bucket (a (vb, EB) mask: O(vb*EB) vector work, no scatter) and
//   carried the result across a sequential edge_block grid axis.  Here one
//   thread block owns one bucket, keeps three (vb,) accumulators in shared
//   memory and walks the bucket's edges in three passes of shared-memory
//   atomicMin: (1) the candidate, as an order-preserving u32 key; (2) lab,
//   over the edges whose key equals its vertex's minimum; (3) src, over the
//   edges whose lab also equals.  O(EB) work a bucket.  Lex-min is exact and
//   independent of order, so the result equals the reference for any
//   edge_block and any schedule of the atomics.  Passes 2 and 3 re-read the
//   bucket's edges (EB*16 bytes) while they are still in L1/L2.  -0.0 is
//   keyed as +0.0, so the two compare equal, as they do as floats.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t IMAX = 0x7fffffff;
constexpr uint32_t EMPTY = 0xffffffffu;  // above the key of every finite float
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Order-preserving map of a finite float to u32 (a < b  <=>  key(a) < key(b)).
__device__ __forceinline__ uint32_t key_of(float c) {
  const uint32_t u = __float_as_uint(__fadd_rn(c, 0.0f));  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <typename TC>
__global__ void segmin_bucketed_kernel(const TC* __restrict__ cand,
                                       const int32_t* __restrict__ ldst,
                                       const int32_t* __restrict__ lab,
                                       const int32_t* __restrict__ src,
                                       float* __restrict__ out_m, int32_t* __restrict__ out_l,
                                       int32_t* __restrict__ out_s, int64_t EB, int vb) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* key = reinterpret_cast<uint32_t*>(smem);
  int32_t* acc_l = reinterpret_cast<int32_t*>(key + vb);
  int32_t* acc_s = acc_l + vb;
  const int64_t base = (int64_t)blockIdx.x * EB;
  for (int v = threadIdx.x; v < vb; v += blockDim.x) {
    key[v] = EMPTY;
    acc_l[v] = IMAX;
    acc_s[v] = IMAX;
  }
  __syncthreads();
  // pass 1: the least candidate of each vertex
  for (int64_t e = threadIdx.x; e < EB; e += blockDim.x) {
    const float c = to_f32(cand[base + e]);
    const int32_t v = __ldg(ldst + base + e);
    if (!isfinite(c) || (uint32_t)v >= (uint32_t)vb) continue;
    atomicMin(key + v, key_of(c));
  }
  __syncthreads();
  // pass 2: the least label among the edges that reach that candidate
  for (int64_t e = threadIdx.x; e < EB; e += blockDim.x) {
    const float c = to_f32(cand[base + e]);
    const int32_t v = __ldg(ldst + base + e);
    if (!isfinite(c) || (uint32_t)v >= (uint32_t)vb) continue;
    if (key_of(c) == key[v]) atomicMin(acc_l + v, __ldg(lab + base + e));
  }
  __syncthreads();
  // pass 3: the least source among the edges that reach both
  for (int64_t e = threadIdx.x; e < EB; e += blockDim.x) {
    const float c = to_f32(cand[base + e]);
    const int32_t v = __ldg(ldst + base + e);
    if (!isfinite(c) || (uint32_t)v >= (uint32_t)vb) continue;
    if (key_of(c) == key[v] && __ldg(lab + base + e) == acc_l[v])
      atomicMin(acc_s + v, __ldg(src + base + e));
  }
  __syncthreads();
  const int64_t obase = (int64_t)blockIdx.x * vb;
  for (int v = threadIdx.x; v < vb; v += blockDim.x) {
    const uint32_t k = key[v];
    out_m[obase + v] = k == EMPTY ? INFINITY : value_of(k);
    out_l[obase + v] = acc_l[v];
    out_s[obase + v] = acc_s[v];
  }
}

template <typename TC>
cudaError_t launch(const void* cand, const void* ldst, const void* lab, const void* src,
                   void* out_m, void* out_l, void* out_s, int64_t NB, int64_t EB, int vb,
                   cudaStream_t stream) {
  const size_t smem = (size_t)vb * 12;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        segmin_bucketed_kernel<TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  segmin_bucketed_kernel<TC><<<(unsigned)NB, THREADS, smem, stream>>>(
      static_cast<const TC*>(cand), static_cast<const int32_t*>(ldst),
      static_cast<const int32_t*>(lab), static_cast<const int32_t*>(src),
      static_cast<float*>(out_m), static_cast<int32_t*>(out_l), static_cast<int32_t*>(out_s),
      EB, vb);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// cand_dtype: 0 = float32, 1 = bfloat16.
int segmin_bucketed(int device, int cand_dtype, const void* cand, const void* ldst,
                    const void* lab, const void* src, void* out_m, void* out_l, void* out_s,
                    int64_t NB, int64_t EB, int vb, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cand_dtype == 0)
    return (int)launch<float>(cand, ldst, lab, src, out_m, out_l, out_s, NB, EB, vb, s);
  if (cand_dtype == 1)
    return (int)launch<__nv_bfloat16>(cand, ldst, lab, src, out_m, out_l, out_s, NB, EB, vb,
                                      s);
  return (int)cudaErrorInvalidValue;
}

const char* segmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
