// Min-plus ELL relaxation for Hopper (sm_90a): the Voronoi-cell hot loop.
//
// For each ELL row r, the lexicographic minimum over lanes j of
//     (dist[nbr[r,j]] + wgt[r,j], lab[nbr[r,j]], nbr[r,j])
// where a lane whose candidate is not finite counts as (+inf, IMAX, IMAX).
// dist/wgt are f32 or bf16 (upcast to f32 before the add, rounded to
// nearest as in the plain version: build without --use_fast_math); ids are
// int32.  Outputs are (R,) f32 / i32 / i32.  Inputs must hold no NaN and no
// -inf (distances are >= 0 or +inf, weights >= 0 or +inf), so a lane with
// weight +inf is inert and its gather is skipped.
//
// minplus_resident  replaces src/repro/kernels/minplus/minplus.py
//   minplus_call (Pallas body _kernel, helper _row_lexmin).
//   Bound: device-memory bytes.  Each call must read nbr+wgt (8 B a lane),
//   dist+lab (8 B a vertex) and write 12 B a row; it does ~2 operations a
//   lane, far below the card's rate, and the dist/lab gathers are random.
//   Design: one warp per row, lane j takes columns j, j+32, ...; nbr and
//   wgt are read coalesced, dist and lab are gathered straight from global
//   memory through the read-only path (the 50 MB L2 holds them up to ~6M
//   vertices), the three keys are reduced with __shfl_xor_sync.  A thread
//   block owns rows_per_block rows with up to 8 warps walking them, and the
//   kernel masks the ragged last block itself.  Row offsets are int64
//   because R*K passes 2**31 above RMAT scale 24.
//
// minplus_blocked   replaces src/repro/kernels/minplus/minplus.py
//   minplus_blocked_call (Pallas body _blocked_kernel, helper _lex_merge).
//   Same function, same bound.  On the TPU the grid's second axis walked
//   source slices in order and revisited the output tile; on the GPU blocks
//   run in parallel and carry nothing from one to the next, so that axis
//   becomes a loop inside the block: one thread per row keeps the three
//   lex accumulators in registers while the block stages each (SB,) slice
//   of dist and lab in shared memory.  Its traffic grows as (R/BR)*N like
//   the TPU kernel's.  Lex-min is exact and order-free, so the output is
//   bitwise equal to minplus_resident's.  N need not be a multiple of SB:
//   the last slice is masked.
//
// The lane axis (the serving path's batch backend: B seed sets over one
// graph, as jax.vmap of the Pallas calls).  dist/lab are (B, N) and the
// outputs (B, R).  vmap gave the Pallas kernels a leading grid axis, so the
// TPU program read every nbr/wgt tile once per lane.
//
// minplus_resident_lanes  one warp per row, as minplus_resident; a warp
//   lane loads its (nbr, wgt) element once and then loops over the B lanes
//   in groups of LANE_GROUP, gathering dist and lab of vertex u for each
//   lane into one register accumulator triple per lane; the shuffle then
//   reduces each lane's triple.  So a round reads the ELL once for
//   B <= LANE_GROUP (a larger B re-reads the row, 256 B at K = 32, from L1
//   once a group).  dist/lab come lane-minor, (N, B): the B values of one
//   vertex are adjacent, so at B = 8 one 32-byte sector serves every lane's
//   gather.  (Gathering from (B, N) rows made 8 random sectors a vertex out
//   of a 537 MB working set, and the kernel ran slower than B launches of
//   minplus_resident, each of whose 67 MB partly fits the 50 MB L2.)
//   Bound: R*K*8 + B*(N*8 + R*12) bytes.  minplus_resident (B = 1) stays as
//   it was, and the single-query path keeps using it.
// minplus_blocked  takes the lane as blockIdx.y: each block stages its own
//   lane's dist/lab slices, so the ELL is read B times (from L2 when it
//   fits).  With gridDim.y = 1 it is the kernel above, unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t IMAX = 0x7fffffff;
constexpr int LANE_GROUP = 8;  // query lanes a warp carries in registers at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (d1, l1, s1) < (d0, l0, s0) lexicographically.
__device__ __forceinline__ bool lex_less(float d1, int32_t l1, int32_t s1, float d0,
                                         int32_t l0, int32_t s0) {
  return d1 < d0 || (d1 == d0 && (l1 < l0 || (l1 == l0 && s1 < s0)));
}

template <typename TD, typename TW>
__global__ void minplus_resident_kernel(const int32_t* __restrict__ nbr,
                                        const TW* __restrict__ wgt,
                                        const TD* __restrict__ dist,
                                        const int32_t* __restrict__ lab,
                                        float* __restrict__ out_m,
                                        int32_t* __restrict__ out_l,
                                        int32_t* __restrict__ out_s, int64_t R, int K,
                                        int rows_per_block) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < R ? row0 + rows_per_block : R;
  for (int64_t r = row0 + warp; r < row_end; r += nwarps) {
    const int64_t base = r * (int64_t)K;
    float bd = INFINITY;
    int32_t bl = IMAX, bs = IMAX;
    for (int j = lane; j < K; j += 32) {
      const float w = to_f32(__ldg(wgt + base + j));
      if (isinf(w)) continue;  // padding lane: +inf whatever dist holds
      const int32_t u = __ldg(nbr + base + j);
      const float c = __fadd_rn(to_f32(__ldg(dist + u)), w);
      if (!isfinite(c)) continue;
      const int32_t l = __ldg(lab + u);
      if (lex_less(c, l, u, bd, bl, bs)) {
        bd = c;
        bl = l;
        bs = u;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int32_t ol = __shfl_xor_sync(0xffffffffu, bl, off);
      const int32_t os = __shfl_xor_sync(0xffffffffu, bs, off);
      if (lex_less(od, ol, os, bd, bl, bs)) {
        bd = od;
        bl = ol;
        bs = os;
      }
    }
    if (lane == 0) {
      out_m[r] = bd;
      out_l[r] = bl;
      out_s[r] = bs;
    }
  }
}

template <typename TD, typename TW>
__global__ void minplus_resident_lanes_kernel(const int32_t* __restrict__ nbr,
                                              const TW* __restrict__ wgt,
                                              const TD* __restrict__ dist,
                                              const int32_t* __restrict__ lab,
                                              float* __restrict__ out_m,
                                              int32_t* __restrict__ out_l,
                                              int32_t* __restrict__ out_s, int64_t R, int K,
                                              int B, int rows_per_block) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int64_t row_end = row0 + rows_per_block < R ? row0 + rows_per_block : R;
  for (int64_t r = row0 + warp; r < row_end; r += nwarps) {
    const int64_t base = r * (int64_t)K;
    for (int b0 = 0; b0 < B; b0 += LANE_GROUP) {
      const int nb = B - b0 < LANE_GROUP ? B - b0 : LANE_GROUP;  // warp-uniform
      float bd[LANE_GROUP];
      int32_t bl[LANE_GROUP], bs[LANE_GROUP];
#pragma unroll
      for (int i = 0; i < LANE_GROUP; ++i) {
        bd[i] = INFINITY;
        bl[i] = IMAX;
        bs[i] = IMAX;
      }
      for (int j = lane; j < K; j += 32) {
        const float w = to_f32(__ldg(wgt + base + j));
        if (isinf(w)) continue;  // padding lane: +inf in every query lane
        const int32_t u = __ldg(nbr + base + j);
#pragma unroll
        for (int i = 0; i < LANE_GROUP; ++i) {
          if (i < nb) {
            const int64_t off = (int64_t)u * B + b0 + i;
            const float c = __fadd_rn(to_f32(__ldg(dist + off)), w);
            if (isfinite(c)) {
              const int32_t l = __ldg(lab + off);
              if (lex_less(c, l, u, bd[i], bl[i], bs[i])) {
                bd[i] = c;
                bl[i] = l;
                bs[i] = u;
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < LANE_GROUP; ++i) {
        if (i < nb) {  // nb is the same in all 32 lanes: every lane shuffles
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float od = __shfl_xor_sync(0xffffffffu, bd[i], off);
            const int32_t ol = __shfl_xor_sync(0xffffffffu, bl[i], off);
            const int32_t os = __shfl_xor_sync(0xffffffffu, bs[i], off);
            if (lex_less(od, ol, os, bd[i], bl[i], bs[i])) {
              bd[i] = od;
              bl[i] = ol;
              bs[i] = os;
            }
          }
          if (lane == 0) {
            const int64_t o = (int64_t)(b0 + i) * R + r;
            out_m[o] = bd[i];
            out_l[o] = bl[i];
            out_s[o] = bs[i];
          }
        }
      }
    }
  }
}

template <typename TD, typename TW>
__global__ void minplus_blocked_kernel(const int32_t* __restrict__ nbr,
                                       const TW* __restrict__ wgt,
                                       const TD* __restrict__ dist,
                                       const int32_t* __restrict__ lab,
                                       float* __restrict__ out_m,
                                       int32_t* __restrict__ out_l,
                                       int32_t* __restrict__ out_s, int64_t R, int K,
                                       int64_t N, int SB) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_lab = reinterpret_cast<int32_t*>(smem);
  TD* s_dist = reinterpret_cast<TD*>(smem + (size_t)SB * sizeof(int32_t));
  // query lane blockIdx.y: its own (N,) dist/lab and (R,) outputs
  dist += (int64_t)blockIdx.y * N;
  lab += (int64_t)blockIdx.y * N;
  out_m += (int64_t)blockIdx.y * R;
  out_l += (int64_t)blockIdx.y * R;
  out_s += (int64_t)blockIdx.y * R;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = r < R;
  const int64_t base = r * (int64_t)K;
  float bd = INFINITY;
  int32_t bl = IMAX, bs = IMAX;
  for (int64_t s0 = 0; s0 < N; s0 += SB) {
    const int len = (int)(N - s0 < SB ? N - s0 : SB);
    __syncthreads();  // every thread is done with the previous slice
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      s_dist[i] = dist[s0 + i];
      s_lab[i] = lab[s0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < K; ++j) {
      const int64_t idx = (int64_t)__ldg(nbr + base + j) - s0;
      if (idx < 0 || idx >= len) continue;  // neighbor outside this slice
      const float w = to_f32(__ldg(wgt + base + j));
      if (isinf(w)) continue;
      const float c = __fadd_rn(to_f32(s_dist[idx]), w);
      if (!isfinite(c)) continue;
      const int32_t l = s_lab[idx];
      const int32_t u = (int32_t)(s0 + idx);
      if (lex_less(c, l, u, bd, bl, bs)) {
        bd = c;
        bl = l;
        bs = u;
      }
    }
  }
  if (live) {
    out_m[r] = bd;
    out_l[r] = bl;
    out_s[r] = bs;
  }
}

// dtype codes: 0 = float32, 1 = bfloat16.
template <template <typename, typename> class Launch, typename... Args>
cudaError_t dispatch(int dist_dtype, int wgt_dtype, Args... args) {
  if (dist_dtype == 0 && wgt_dtype == 0) return Launch<float, float>::run(args...);
  if (dist_dtype == 0 && wgt_dtype == 1) return Launch<float, __nv_bfloat16>::run(args...);
  if (dist_dtype == 1 && wgt_dtype == 0) return Launch<__nv_bfloat16, float>::run(args...);
  if (dist_dtype == 1 && wgt_dtype == 1)
    return Launch<__nv_bfloat16, __nv_bfloat16>::run(args...);
  return cudaErrorInvalidValue;
}

template <typename TD, typename TW>
struct LaunchResident {
  static cudaError_t run(const void* nbr, const void* wgt, const void* dist, const void* lab,
                         void* out_m, void* out_l, void* out_s, int64_t R, int K,
                         int rows_per_block, cudaStream_t stream) {
    const int warps = rows_per_block < 8 ? rows_per_block : 8;
    const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
    minplus_resident_kernel<TD, TW><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        static_cast<const int32_t*>(nbr), static_cast<const TW*>(wgt),
        static_cast<const TD*>(dist), static_cast<const int32_t*>(lab),
        static_cast<float*>(out_m), static_cast<int32_t*>(out_l),
        static_cast<int32_t*>(out_s), R, K, rows_per_block);
    return cudaGetLastError();
  }
};

template <typename TD, typename TW>
struct LaunchResidentLanes {
  static cudaError_t run(const void* nbr, const void* wgt, const void* dist, const void* lab,
                         void* out_m, void* out_l, void* out_s, int64_t R, int K, int B,
                         int rows_per_block, cudaStream_t stream) {
    const int warps = rows_per_block < 8 ? rows_per_block : 8;
    const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
    minplus_resident_lanes_kernel<TD, TW><<<(unsigned)blocks, warps * 32, 0, stream>>>(
        static_cast<const int32_t*>(nbr), static_cast<const TW*>(wgt),
        static_cast<const TD*>(dist), static_cast<const int32_t*>(lab),
        static_cast<float*>(out_m), static_cast<int32_t*>(out_l),
        static_cast<int32_t*>(out_s), R, K, B, rows_per_block);
    return cudaGetLastError();
  }
};

template <typename TD, typename TW>
struct LaunchBlocked {
  static cudaError_t run(const void* nbr, const void* wgt, const void* dist, const void* lab,
                         void* out_m, void* out_l, void* out_s, int64_t R, int K, int64_t N,
                         int SB, int B, int rows_per_block, cudaStream_t stream) {
    const size_t smem = (size_t)SB * (sizeof(int32_t) + sizeof(TD));
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          minplus_blocked_kernel<TD, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return e;
    }
    const int64_t blocks = (R + rows_per_block - 1) / rows_per_block;
    const dim3 grid((unsigned)blocks, (unsigned)B);
    minplus_blocked_kernel<TD, TW><<<grid, rows_per_block, smem, stream>>>(
        static_cast<const int32_t*>(nbr), static_cast<const TW*>(wgt),
        static_cast<const TD*>(dist), static_cast<const int32_t*>(lab),
        static_cast<float*>(out_m), static_cast<int32_t*>(out_l),
        static_cast<int32_t*>(out_s), R, K, N, SB);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" {

int minplus_resident(int device, int dist_dtype, int wgt_dtype, const void* nbr,
                     const void* wgt, const void* dist, const void* lab, void* out_m,
                     void* out_l, void* out_s, int64_t R, int K, int rows_per_block,
                     void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch<LaunchResident>(dist_dtype, wgt_dtype, nbr, wgt, dist, lab, out_m,
                                       out_l, out_s, R, K, rows_per_block,
                                       static_cast<cudaStream_t>(stream));
}

// dist/lab lane-minor: (N, B).
int minplus_resident_lanes(int device, int dist_dtype, int wgt_dtype, const void* nbr,
                           const void* wgt, const void* dist, const void* lab, void* out_m,
                           void* out_l, void* out_s, int64_t R, int K, int B,
                           int rows_per_block, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch<LaunchResidentLanes>(dist_dtype, wgt_dtype, nbr, wgt, dist, lab,
                                            out_m, out_l, out_s, R, K, B, rows_per_block,
                                            static_cast<cudaStream_t>(stream));
}

// B query lanes (gridDim.y); B = 1 for an (N,) dist.
int minplus_blocked(int device, int dist_dtype, int wgt_dtype, const void* nbr,
                    const void* wgt, const void* dist, const void* lab, void* out_m,
                    void* out_l, void* out_s, int64_t R, int K, int64_t N, int SB, int B,
                    int rows_per_block, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  return (int)dispatch<LaunchBlocked>(dist_dtype, wgt_dtype, nbr, wgt, dist, lab, out_m,
                                      out_l, out_s, R, K, N, SB, B, rows_per_block,
                                      static_cast<cudaStream_t>(stream));
}

const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
