// Min-plus ELL relaxation for Hopper (sm_90a): the Voronoi-cell hot loop.
//
// For each ELL row r, the lexicographic minimum over slots j of
//     (dist[nbr[r,j]] + wgt[r,j], lab[nbr[r,j]], nbr[r,j])
// where a slot whose candidate is not finite counts as (+inf, IMAX, IMAX).
// dist/wgt are f32 or bf16 (upcast to f32 before the add, rounded to
// nearest as in the plain version: build without --use_fast_math); ids are
// int32.  Outputs are (R,) f32 / i32 / i32, or (B, R) with B query lanes.
// Inputs must hold no NaN and no -inf (distances are >= 0 or +inf, weights
// >= 0 or +inf), so a slot with weight +inf is inert and its gather is
// skipped.  Lex-min is exact and order-free: any slot order, any split of
// the work gives the same triple, bit for bit.
//
// minplus_resident_lanes  replaces src/repro/kernels/minplus/minplus.py
//   minplus_call (Pallas body _kernel, helper _row_lexmin) and, with B > 1
//   lanes, its jax.vmap over B seed sets; an (N,) input is its B = 1 case.
//
//   Bound: device-memory bytes.  A call must stream the ELL (nbr + wgt,
//   8 B a slot: 3.0 GB at RMAT scale 23, K = 32), read each vertex's dist
//   and lab once a lane and write 12 B a row a lane; it does ~2 operations
//   a slot, far below the card's rate.  The gathers are random: a live
//   slot costs at least one 32-byte sector from L2 or device memory.
//
//   What held the first designs back (a warp a row; then a lane axis over
//   (N, B) copies; 5.1x and 14.4x the bound at full width on an H100):
//   - one warp per row made each row a chain of four dependent trips to
//     memory (wgt, then nbr, then dist, then lab) and a 15-step shuffle
//     reduce, with at most 64 rows in flight an SM: latency, not bytes;
//   - dist and lab lived in two arrays, so a live slot cost two gathered
//     sectors; with B lanes, 16 scalar gathers and 120 shuffles a row;
//   - the 3 GB ELL stream went through L2 at normal priority and evicted
//     the dist/lab table the gathers wanted to find there.
//
//   Design now:
//   - one gather a live slot: pack_records_kernel (one pass before each
//     launch, in the wrapper's time) writes dist (as f32 bits) and lab as
//     one 8-byte record per vertex and lane, lane-minor, so the B records
//     of a vertex are adjacent (B > 1 pads the stride to an even lane
//     count, so a thread loads two lanes as one 16-byte vector);
//   - the ELL stream off the critical path: persistent blocks walk row
//     tiles; a producer warp stages each tile's nbr and wgt in shared
//     memory with TMA bulk copies (cp.async.bulk, completing on an
//     mbarrier) into a ring of 2..4 stages, so the next tiles load while
//     this one gathers; the copies carry an L2 evict-first hint;
//   - no shuffles: each consumer thread owns one (row, lane group) item,
//     folds the row's slots from shared memory into register triples, and
//     issues the gathers of U slots before it consumes any of them, so a
//     row waits on ceil(K / U) gather round trips, not 4 K / 32;
//   - the slot order is rotated by the row's index in the tile, so the
//     rows a warp reads hit distinct shared-memory banks (K = 32).
//   Both kernels share this body: the single one folds one lane a thread
//   from one 8-byte record a vertex (67 MB at scale 23, not padded to two
//   lanes), the lane one a lane pair a thread.  A (1, N) lane input
//   launches the single kernel: with its lane counts fixed at compile time
//   it is ~5 % faster than the lane body at B = 1 (runtime division by the
//   pair count a work item).
//   Bulk copies need 16-byte aligned sources and sizes: the wrapper takes
//   nbr and wgt only if they start on 16 bytes, and a tile is a multiple
//   of 8 rows, so every tile but the last starts and ends on 16 bytes (f32
//   and bf16, any K); the producer copies the last tile's ragged tail bytes
//   by hand before it arms the barrier.  Rows too wide for two stages of 8
//   rows in shared memory (K above ~1800 in f32, ~2400 in bf16) get no
//   ring: the consumers read them in place, the same fold from global
//   memory, slower but exact.
//
// minplus_blocked          replaces src/repro/kernels/minplus/minplus.py
//   minplus_blocked_call (Pallas body _blocked_kernel, helper _lex_merge).
//   Same function, same bound.  On the TPU the grid's second axis walked
//   source slices in order and revisited the output tile; on the GPU blocks
//   run in parallel and carry nothing from one to the next, so that axis
//   becomes a loop inside the block: one thread per row keeps the three
//   lex accumulators in registers while the block stages each (SB,) slice
//   of dist and lab in shared memory.  Its traffic grows as (R/BR)*N like
//   the TPU kernel's.  N need not be a multiple of SB: the last slice is
//   masked.  With a lane axis, blockIdx.y is the query lane: each block
//   stages its own lane's slices, so the ELL is read B times (from L2 when
//   it fits).  It takes dist/lab as they are (no records).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t IMAX = 0x7fffffff;
constexpr int32_t INF_BITS = 0x7f800000;  // +inf as f32 bits
constexpr int MAX_STAGES = 4;
constexpr int MAX_CONSUMERS = 256;       // consumer threads of a block (8 warps)
constexpr int SMEM_HEADER = 128;         // bytes before the first stage: the mbarriers
constexpr size_t MAX_SMEM = 232448;      // shared memory one block can use on Hopper
// Slots whose gathers a thread issues together, for one lane (U1) and for a
// lane pair (U2), and the ring bytes a block aims at: the fastest of the
// values tried at full width on an H100 (see PERF.md).
constexpr int U1 = 16;
constexpr int U2 = 8;
constexpr size_t RING_BUDGET = 96 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// (d1, l1, s1) < (d0, l0, s0) lexicographically.
__device__ __forceinline__ bool lex_less(float d1, int32_t l1, int32_t s1, float d0,
                                         int32_t l0, int32_t s0) {
  return d1 < d0 || (d1 == d0 && (l1 < l0 || (l1 == l0 && s1 < s0)));
}

// ---- mbarrier and bulk-copy helpers (PTX, sm_90)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity ``parity`` of ``bar`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

// TMA 1-D bulk copy global -> shared, completing ``bytes`` on ``bar``.
// dst, src and bytes must be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t pol) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar)), "l"(pol)
      : "memory");
}

// ---- records: (dist f32 bits, lab) of G adjacent lanes of one vertex

template <int G>
__device__ __forceinline__ void load_records(const int2* __restrict__ p, int32_t (&d)[G],
                                             int32_t (&l)[G]);

template <>
__device__ __forceinline__ void load_records<1>(const int2* __restrict__ p, int32_t (&d)[1],
                                                int32_t (&l)[1]) {
  const int2 v = __ldg(p);
  d[0] = v.x;
  l[0] = v.y;
}

template <>
__device__ __forceinline__ void load_records<2>(const int2* __restrict__ p, int32_t (&d)[2],
                                                int32_t (&l)[2]) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(p));
  d[0] = v.x;
  l[0] = v.y;
  d[1] = v.z;
  l[1] = v.w;
}

// Folds the K slots of one staged row into G lane triples.  U slots at a
// time: their (nbr, wgt) from shared memory, then all their gathers, then
// the compares, so up to U gathers a thread are in flight together.
template <typename TW, int G, int U>
__device__ __forceinline__ void fold_row(const int32_t* __restrict__ sn,
                                         const TW* __restrict__ sw, int K, int rot,
                                         const int2* __restrict__ rec, int64_t stride,
                                         float (&bd)[G], int32_t (&bl)[G], int32_t (&bs)[G]) {
  for (int j0 = 0; j0 < K; j0 += U) {
    int32_t u[U];
    float w[U];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      u[i] = 0;
      w[i] = INFINITY;
      if (j0 + i < K) {
        int j = j0 + i + rot;  // rot < K, so one subtraction wraps it
        if (j >= K) j -= K;
        u[i] = sn[j];
        w[i] = to_f32(sw[j]);
      }
    }
    int32_t rd[U][G], rl[U][G];
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if (!isinf(w[i])) {
        load_records<G>(rec + (int64_t)u[i] * stride, rd[i], rl[i]);
      } else {  // padding slot: inert, no gather
#pragma unroll
        for (int g = 0; g < G; ++g) {
          rd[i][g] = INF_BITS;
          rl[i][g] = IMAX;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < U; ++i) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float c = __fadd_rn(__int_as_float(rd[i][g]), w[i]);
        if (isfinite(c) && lex_less(c, rl[i][g], u[i], bd[g], bl[g], bs[g])) {
          bd[g] = c;
          bl[g] = rl[i][g];
          bs[g] = u[i];
        }
      }
    }
  }
}

// Folds the items of one tile of ``rows`` rows from row ``row0`` on, whose
// nbr and wgt start at sn and sw (the tile's stage in shared memory, or the
// ELL itself): (row, lane group) pairs, row-major, P groups a row of G
// lanes each; group p covers lanes p*G .. p*G + G - 1 (< B).  rec holds
// ``stride`` records a vertex.
template <typename TW, int G>
__device__ __forceinline__ void fold_tile(const int32_t* __restrict__ sn,
                                          const TW* __restrict__ sw, int64_t row0, int rows,
                                          const int2* __restrict__ rec,
                                          float* __restrict__ out_m,
                                          int32_t* __restrict__ out_l,
                                          int32_t* __restrict__ out_s, int64_t R, int K, int B,
                                          int stride, int P, int CT) {
  constexpr int U = G == 1 ? U1 : U2;
  for (int it = threadIdx.x; it < rows * P; it += CT) {
    const int rr = it / P;
    const int p = it - rr * P;
    float bd[G];
    int32_t bl[G], bs[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      bd[g] = INFINITY;
      bl[g] = IMAX;
      bs[g] = IMAX;
    }
    fold_row<TW, G, U>(sn + (int64_t)rr * K, sw + (int64_t)rr * K, K, K ? rr % K : 0,
                       rec + p * G, stride, bd, bl, bs);
    const int64_t r = row0 + rr;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int b = p * G + g;
      if (b < B) {
        const int64_t o = (int64_t)b * R + r;
        out_m[o] = bd[g];
        out_l[o] = bl[g];
        out_s[o] = bs[g];
      }
    }
  }
}

// The body both resident kernels share.  Block: CT consumer threads, then
// one producer warp.  Shared memory: full[S], empty[S] mbarriers, then S
// stages of (TR*K nbr, TR*K wgt).  Block b walks tiles b, b + grid, ...
// S = 0 (rows too wide for two stages of 8): no ring, the consumers read
// their rows' nbr and wgt in place.
template <typename TW, int G>
__device__ __forceinline__ void relax_tiles(const int32_t* __restrict__ nbr,
                                            const TW* __restrict__ wgt,
                                            const int2* __restrict__ rec,
                                            float* __restrict__ out_m,
                                            int32_t* __restrict__ out_l,
                                            int32_t* __restrict__ out_s, int64_t R, int K,
                                            int B, int stride, int P, int TR, int S, int CT) {
  const int64_t ntiles = (R + TR - 1) / TR;
  if (S == 0) {
    if (threadIdx.x >= CT) return;
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int64_t row0 = t * TR;
      const int rows = (int)(R - row0 < TR ? R - row0 : TR);
      fold_tile<TW, G>(nbr + row0 * K, wgt + row0 * K, row0, rows, rec, out_m, out_l, out_s,
                       R, K, B, stride, P, CT);
    }
    return;
  }
  extern __shared__ __align__(128) unsigned char ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring);
  uint64_t* empty = full + MAX_STAGES;
  const size_t nbr_bytes = (size_t)TR * K * sizeof(int32_t);  // a multiple of 32
  const size_t stage_bytes = nbr_bytes + (size_t)TR * K * sizeof(TW);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CT / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CT) {  // producer warp: one thread issues the copies
    if (threadIdx.x != CT) return;
    const uint64_t pol = evict_first_policy();
    int i = 0;
    for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
      const int s = i % S;
      mbar_wait(&empty[s], ((i / S) & 1) ^ 1);  // the first round passes at once
      // the consumers' reads of this stage come before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      unsigned char* st = ring + SMEM_HEADER + s * stage_bytes;
      const int64_t row0 = t * TR;
      const int64_t rows = R - row0 < TR ? R - row0 : TR;
      const uint32_t bn = (uint32_t)(rows * K * sizeof(int32_t));
      const uint32_t bw = (uint32_t)(rows * K * sizeof(TW));
      const uint32_t cn = bn & ~15u, cw = bw & ~15u;  // the bulk parts
      const unsigned char* gn = reinterpret_cast<const unsigned char*>(nbr + row0 * K);
      const unsigned char* gw = reinterpret_cast<const unsigned char*>(wgt + row0 * K);
      for (uint32_t b = cn; b < bn; ++b) st[b] = gn[b];  // the last tile's tail
      for (uint32_t b = cw; b < bw; ++b) st[nbr_bytes + b] = gw[b];
      mbar_arrive_expect_tx(&full[s], cn + cw);  // releases the tail stores too
      if (cn) bulk_load(st, gn, cn, &full[s], pol);
      if (cw) bulk_load(st + nbr_bytes, gw, cw, &full[s], pol);
    }
    return;
  }

  int i = 0;
  for (int64_t t = blockIdx.x; t < ntiles; t += gridDim.x, ++i) {
    const int s = i % S;
    mbar_wait(&full[s], (i / S) & 1);
    const unsigned char* st = ring + SMEM_HEADER + s * stage_bytes;
    const int64_t row0 = t * TR;
    const int rows = (int)(R - row0 < TR ? R - row0 : TR);
    fold_tile<TW, G>(reinterpret_cast<const int32_t*>(st),
                     reinterpret_cast<const TW*>(st + nbr_bytes), row0, rows, rec, out_m, out_l,
                     out_s, R, K, B, stride, P, CT);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);  // this warp is done with stage s
  }
}

// One query: (N,) records, one lane.
template <typename TW>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32)
    minplus_resident_kernel(const int32_t* __restrict__ nbr, const TW* __restrict__ wgt,
                            const int2* __restrict__ rec, float* __restrict__ out_m,
                            int32_t* __restrict__ out_l, int32_t* __restrict__ out_s,
                            int64_t R, int K, int TR, int S, int CT) {
  relax_tiles<TW, 1>(nbr, wgt, rec, out_m, out_l, out_s, R, K, 1, 1, 1, TR, S, CT);
}

// B > 1 query lanes: (N, stride) lane-minor records, a lane pair a thread.
template <typename TW>
__global__ void __launch_bounds__(MAX_CONSUMERS + 32)
    minplus_resident_lanes_kernel(const int32_t* __restrict__ nbr,
                                  const TW* __restrict__ wgt, const int2* __restrict__ rec,
                                  float* __restrict__ out_m, int32_t* __restrict__ out_l,
                                  int32_t* __restrict__ out_s, int64_t R, int K, int B,
                                  int stride, int P, int TR, int S, int CT) {
  relax_tiles<TW, 2>(nbr, wgt, rec, out_m, out_l, out_s, R, K, B, stride, P, TR, S, CT);
}

// The record table the resident kernels gather from: rec[u * stride + b] =
// (dist[b, u] as f32 bits, lab[b, u]) for b < B, (+inf, IMAX) for the
// padding lane of an odd B.  Stride 1: one thread a vertex.  Else one
// thread a (vertex, lane pair), pairs fastest, so a warp writes whole
// 16-byte runs side by side and reads each lane's dist/lab in runs of
// consecutive vertices.
template <typename TD>
__global__ void pack_records_kernel(const TD* __restrict__ dist,
                                    const int32_t* __restrict__ lab, int2* __restrict__ rec,
                                    int64_t N, int B, int stride) {
  if (stride == 1) {
    const int64_t step = (int64_t)gridDim.x * blockDim.x;
    for (int64_t u = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; u < N; u += step)
      rec[u] = make_int2(__float_as_int(to_f32(dist[u])), lab[u]);
    return;
  }
  const int P = stride / 2;                            // lane pairs a vertex
  const int per = P < (int)blockDim.x ? P : (int)blockDim.x;  // threads a vertex
  const int vpb = blockDim.x / per;                    // vertices a block step
  const int uo = threadIdx.x / per, p0 = threadIdx.x % per;
  if (uo >= vpb) return;
  for (int64_t u = (int64_t)blockIdx.x * vpb + uo; u < N; u += (int64_t)gridDim.x * vpb) {
    for (int p = p0; p < P; p += per) {
      const int b = 2 * p;
      int4 v = make_int4(INF_BITS, IMAX, INF_BITS, IMAX);
      if (b < B) {
        v.x = __float_as_int(to_f32(dist[(int64_t)b * N + u]));
        v.y = lab[(int64_t)b * N + u];
      }
      if (b + 1 < B) {
        v.z = __float_as_int(to_f32(dist[(int64_t)(b + 1) * N + u]));
        v.w = lab[(int64_t)(b + 1) * N + u];
      }
      reinterpret_cast<int4*>(rec + u * stride)[p] = v;
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

// ---- host side

// Tile rows, stages and consumer threads of a resident launch.  A tile
// holds about ``block_rows`` (row, lane group) items, rounded to a
// multiple of 8 rows (16-byte aligned bulk copies); the ring takes
// RING_BUDGET bytes (2..4 stages) unless two stages need more.  Rows too
// wide for two stages of 8 rows in shared memory (K above ~1800 in f32,
// ~2400 in bf16) get no ring (S = 0): the kernel reads them in place.
struct TilePlan {
  int TR, S, CT;
  size_t smem;
};

TilePlan plan_tiles(int K, size_t wgt_size, int P, int block_rows) {
  const size_t row_bytes = (size_t)(K > 0 ? K : 1) * (sizeof(int32_t) + wgt_size);
  int TR = (block_rows / P) & ~7;
  if (TR < 8) TR = 8;
  int S = 0;
  size_t stage = 0;
  if (SMEM_HEADER + 2 * 8 * row_bytes <= MAX_SMEM) {
    while (TR > 8 && SMEM_HEADER + 2 * TR * row_bytes > MAX_SMEM) TR = ((TR / 2) + 7) & ~7;
    stage = TR * row_bytes;
    S = (int)(RING_BUDGET / stage);
    if (S < 2) S = 2;
    if (S > MAX_STAGES) S = MAX_STAGES;
  }
  const int64_t items = (int64_t)TR * P;
  const int CT = (int)(items < MAX_CONSUMERS ? (items + 31) & ~31 : MAX_CONSUMERS);
  return TilePlan{TR, S, CT, S ? SMEM_HEADER + S * stage : 0};
}

// Launches ``kernel`` persistent: as many blocks as fit on the card at
// once, at most one a tile.
template <typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int device, int64_t R, const TilePlan& pl,
                              cudaStream_t stream, Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)pl.smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, pl.CT + 32, pl.smem);
  if (e != cudaSuccess) return e;
  if (per_sm == 0) return cudaErrorInvalidConfiguration;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t ntiles = (R + pl.TR - 1) / pl.TR;
  const int64_t grid = ntiles < (int64_t)per_sm * sms ? ntiles : (int64_t)per_sm * sms;
  kernel<<<(unsigned)grid, pl.CT + 32, pl.smem, stream>>>(args...);
  return cudaGetLastError();
}

// B query lanes over (N, stride) records.  One lane (stride 1) launches the
// single kernel: its lane counts are fixed at compile time.
template <typename TW>
cudaError_t run_resident(int device, const void* nbr, const void* wgt, const void* rec,
                         void* out_m, void* out_l, void* out_s, int64_t R, int K, int B,
                         int stride, int block_rows, cudaStream_t stream) {
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const TW* w = static_cast<const TW*>(wgt);
  const int2* r = static_cast<const int2*>(rec);
  float* om = static_cast<float*>(out_m);
  int32_t* ol = static_cast<int32_t*>(out_l);
  int32_t* os = static_cast<int32_t*>(out_s);
  if (B == 1) {
    if (stride != 1) return cudaErrorInvalidValue;
    const TilePlan pl = plan_tiles(K, sizeof(TW), 1, block_rows);
    return launch_persistent(minplus_resident_kernel<TW>, device, R, pl, stream, n, w, r, om,
                             ol, os, R, K, pl.TR, pl.S, pl.CT);
  }
  if (stride % 2 != 0 || stride < B) return cudaErrorInvalidValue;
  const int P = stride / 2;
  const TilePlan pl = plan_tiles(K, sizeof(TW), P, block_rows);
  return launch_persistent(minplus_resident_lanes_kernel<TW>, device, R, pl, stream, n, w, r,
                           om, ol, os, R, K, B, stride, P, pl.TR, pl.S, pl.CT);
}

template <typename TD>
cudaError_t run_pack(int device, const void* dist, const void* lab, void* rec, int64_t N, int B,
                     int stride, cudaStream_t stream) {
  int sms = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return e;
  const int64_t pairs = stride == 1 ? 1 : stride / 2;  // threads a vertex (up to 256)
  const int64_t per_block = 256 / (pairs < 256 ? pairs : 256);
  const int64_t want = (N + per_block - 1) / per_block, cap = (int64_t)sms * 16;
  pack_records_kernel<TD><<<(unsigned)(want < cap ? want : cap), 256, 0, stream>>>(
      static_cast<const TD*>(dist), static_cast<const int32_t*>(lab), static_cast<int2*>(rec),
      N, B, stride);
  return cudaGetLastError();
}

template <typename TD, typename TW>
cudaError_t run_blocked(const void* nbr, const void* wgt, const void* dist, const void* lab,
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

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Records: int32 pairs (dist as
// f32 bits, lab), 16-byte aligned, as minplus_pack_records writes them.
extern "C" {

// dist/lab: (B, N) (B = 1 for (N,)); rec: (N, stride) records, stride = 1
// for B = 1, else B rounded up to even.
int minplus_pack_records(int device, int dist_dtype, const void* dist, const void* lab,
                         void* rec, int64_t N, int B, int stride, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  if (N == 0) return 0;
  if (stride != (B == 1 ? 1 : B + B % 2)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dist_dtype == 0) return (int)run_pack<float>(device, dist, lab, rec, N, B, stride, st);
  if (dist_dtype == 1)
    return (int)run_pack<__nv_bfloat16>(device, dist, lab, rec, N, B, stride, st);
  return (int)cudaErrorInvalidValue;
}

// rec: (N, stride) lane-minor records, stride = 1 for B = 1, else even.
int minplus_resident_lanes(int device, int wgt_dtype, const void* nbr, const void* wgt,
                           const void* rec, void* out_m, void* out_l, void* out_s, int64_t R,
                           int K, int B, int stride, int block_rows, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wgt_dtype == 0)
    return (int)run_resident<float>(device, nbr, wgt, rec, out_m, out_l, out_s, R, K, B,
                                    stride, block_rows, st);
  if (wgt_dtype == 1)
    return (int)run_resident<__nv_bfloat16>(device, nbr, wgt, rec, out_m, out_l, out_s, R, K,
                                            B, stride, block_rows, st);
  return (int)cudaErrorInvalidValue;
}

// B query lanes (gridDim.y); B = 1 for an (N,) dist.
int minplus_blocked(int device, int dist_dtype, int wgt_dtype, const void* nbr,
                    const void* wgt, const void* dist, const void* lab, void* out_m,
                    void* out_l, void* out_s, int64_t R, int K, int64_t N, int SB, int B,
                    int rows_per_block, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dist_dtype == 0 && wgt_dtype == 0)
    return (int)run_blocked<float, float>(nbr, wgt, dist, lab, out_m, out_l, out_s, R, K, N,
                                          SB, B, rows_per_block, st);
  if (dist_dtype == 0 && wgt_dtype == 1)
    return (int)run_blocked<float, __nv_bfloat16>(nbr, wgt, dist, lab, out_m, out_l, out_s, R,
                                                  K, N, SB, B, rows_per_block, st);
  if (dist_dtype == 1 && wgt_dtype == 0)
    return (int)run_blocked<__nv_bfloat16, float>(nbr, wgt, dist, lab, out_m, out_l, out_s, R,
                                                  K, N, SB, B, rows_per_block, st);
  if (dist_dtype == 1 && wgt_dtype == 1)
    return (int)run_blocked<__nv_bfloat16, __nv_bfloat16>(nbr, wgt, dist, lab, out_m, out_l,
                                                          out_s, R, K, N, SB, B,
                                                          rows_per_block, st);
  return (int)cudaErrorInvalidValue;
}

const char* minplus_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
