// Sampler prep for Hopper (sm_90a), CUDA C++: one thread-block cluster a
// row, radix selects for the top-k and top-p thresholds.
//
// Replaces: paddle_tpu/ops/pallas/fused_sample.py `fused_sample_prep`
// (`_sample_kernel` :59, pallas_call at :113) — kernel A7.
//
// What it computes, per row of f32 logits [B, V]: the argmax of the raw
// logits (first index on ties); l = logits / max(t, 1e-6); with
// 0 < top_k < V every l below the k-th largest becomes -inf (ties at the
// k-th value stay); then the top-p cutoff, the smallest kept value v whose
// exclusive prefix mass in the descending order, mass(l > v) / total, is
// below top_p, and every l below it becomes -inf (top_p <= 0 masks the
// whole row, top_p > 1 nothing). Emits the masked logits and the argmax;
// the categorical draw stays outside.
//
// Bound on the H100: bytes — one read and one write of B * V * 4 bytes
// (2 MB at B = 8, V = 32000: 0.6 us) against a few operations an element.
// At decode sizes the time is latency: the launch, and the rounds in which
// the blocks of a row agree on a value.
//
// Design. A row belongs to one cluster of `cluster` blocks (up to 16; past
// 8 a non-portable size), each block a `slice` of the row. A block loads
// its slice once by bulk copy (cp.async.bulk on an mbarrier; the head and
// tail that are not 16-byte aligned by plain loads) and keeps it, divided
// by t, in shared memory for every later pass. A slice longer than `tile`
// floats is streamed instead: each pass re-reads it tile by tile (from L2).
//
// The thresholds come from selection, not sorting: order-preserving uint32
// keys of l (-0.0 keyed as +0.0, since the two compare equal), three
// digits of `bits` from the top. For each digit every block builds a
// histogram over its entries that match the prefix chosen so far (32-bit
// integer atomics in shared memory, a bin's low and high words) and the
// totals of its 64 groups of bins; one cluster barrier; then every block
// gathers all blocks' group totals through distributed shared memory,
// takes the group, gathers that group's bins from all blocks and takes the
// bin: the same numbers in the same order in every block, so every block
// takes the same bin, and no second launch is needed. Histograms are
// double-buffered by the digit's parity, as a block may start a digit
// while a slower one still reads its last. The top-k select counts entries
// and takes the bin that holds the k-th from the top. The top-p select
// weighs the top-k survivors by their mass, exp(l - max) as the fixed-point
// integer round(mass * 2^shift), with shift chosen so that
// V * 2^shift <= 2^63: every sum is exact, so no summation order enters
// and no float atomics exist. It takes the lowest bin holding mass whose
// mass above is below ceil(top_p * total), that compared in integers too.
// A bin that holds no mass is never the cutoff: its entries lie below
// every entry with mass, and their exclusive prefix mass is the whole,
// which is not below top_p <= 1.
//
// The time is the chain of these rounds, not bytes: a digit waits for its
// histogram, one barrier and two round trips of remote reads, which are
// slow and narrow next to local shared memory, so a digit gathers group
// totals and one group's bins (6 KB a block at 8 blocks) rather than
// whole histograms (16 KB). Given a `stamps` buffer, the first block of
// row 0 records clock64 and %globaltimer at each phase's end (the load,
// the argmax round, each digit's histogram, barrier, group gather and bin
// gather, the write); `chip_smoke.py` prints them.
//
// The masked row is written from shared memory in a last pass. The plan
// (cluster, slice, tile, shift, bits) is the wrapper's `sample_plan(V)`, a
// function of V alone, so a row's bits do not depend on the batch.
#include <cooperative_groups.h>

#include "flash_sm90.cuh"

namespace cg = cooperative_groups;

namespace {

using flash::sm90::mbar_arrive_tx;
using flash::sm90::mbar_init;
using flash::sm90::mbar_init_fence;
using flash::sm90::mbar_wait;
using flash::sm90::smem_u32;
using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kDigits = 3;
constexpr int kMaxCluster = 16;
constexpr int kMaxBits = 11;
constexpr int kCopyFloats = 4096;       // floats a bulk copy (16 KB)
constexpr int kGroups = 64;             // a digit's bins come in 64 groups
constexpr int kSmemLimit = 232448;      // dynamic shared memory of a block
constexpr int kStamps = 32;             // phase stamps a launch, at most

struct Plan {
  int cluster;        // blocks a row, one cluster
  int slice;          // floats a block (the last may hold fewer)
  int tile;           // floats a tile: a slice no longer stays resident
  int shift;          // a survivor's mass is round(exp(l - max) * 2^shift)
  int bits[kDigits];  // digit widths from the top, summing to 32
};

__host__ __device__ inline int max_bits(const Plan& p) {
  int m = 0;
  for (int d = 0; d < kDigits; ++d) m = p.bits[d] > m ? p.bits[d] : m;
  return m;
}

// dynamic shared memory: two histograms (low and high words of their
// bins), two sets of group totals, the gathers' table, the tile
__host__ __device__ inline size_t smem_bytes(const Plan& p) {
  return 8 * static_cast<size_t>(2 * (1 << max_bits(p)) + 2 * kGroups +
                                 p.cluster * kGroups) +
         4 * static_cast<size_t>(p.tile + 4);
}

struct ArgMax {
  float v;
  int i;
};

struct Pick {
  int bin;            // the digit taken (first its group)
  int found;          // 0: no bin qualified (top-p: nothing is kept)
  u64 above;          // count or mass strictly above the bin
  u64 target;         // k, or ceil(top_p * total) once the total is known
};

struct Shared {
  uint64_t bar;
  Pick pick;
  int stamps;         // phase stamps taken
  ArgMax am[kWarps];
  ArgMax slice_best;  // this block's argmax, read by the cluster
  ArgMax row_best;
};

// A phase ends: thread 0 of row 0's first block records (clock64,
// %globaltimer) when the launch has a stamps buffer.
__device__ __forceinline__ void stamp(long long* stamps, Shared& sh) {
  if (stamps == nullptr || blockIdx.x != 0 || blockIdx.y != 0 ||
      threadIdx.x != 0 || sh.stamps == kStamps)
    return;
  long long g;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
  stamps[2 * sh.stamps] = clock64();
  stamps[2 * sh.stamps + 1] = g;
  ++sh.stamps;
}

// order-preserving key: a larger value has a larger key; -0.0 keys as +0.0
__device__ __forceinline__ uint32_t key_of(float v) {
  const uint32_t u = __float_as_uint(v == 0.f ? 0.f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax x) {
  for (int off = 16; off > 0; off >>= 1) {
    const ArgMax o{__shfl_xor_sync(0xffffffffu, x.v, off),
                   __shfl_xor_sync(0xffffffffu, x.i, off)};
    x = better(x, o);
  }
  return x;
}

// Add v to bin b of a histogram held as 32-bit low and high words: shared
// memory adds 32-bit integers natively (64-bit ones by compare-and-swap,
// which contention on a row's few hot bins turns into retries). The low
// word's add returns its old value, which says whether it carried.
__device__ __forceinline__ void hist_add(uint32_t* lo, uint32_t* hi, int b,
                                         u64 v) {
  const uint32_t l = static_cast<uint32_t>(v);
  uint32_t h = static_cast<uint32_t>(v >> 32);
  if (l && atomicAdd(&lo[b], l) > 0xffffffffu - l) ++h;
  if (h) atomicAdd(&hi[b], h);
}

// ceil(top_p * total) for 0 < top_p <= 1, exactly: top_p = m * 2^-e with
// m < 2^24 and e >= 23, so m * total < 2^87
__device__ u64 mass_target(float top_p, u64 total) {
  const uint32_t b = __float_as_uint(top_p);
  int ex = static_cast<int>((b >> 23) & 0xff);
  u64 m = b & 0x7fffffu;
  if (ex) m |= 0x800000u; else ex = 1;
  const int e = 150 - ex;
  const unsigned __int128 prod = static_cast<unsigned __int128>(m) * total;
  if (e >= 88) return prod != 0;
  const unsigned __int128 one = 1;
  return static_cast<u64>((prod + (one << e) - 1) >> e);
}

__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This block's part of the row.
struct Slice {
  const float* src;   // its first logit
  float* dst;         // its first output
  int len;            // its elements
  int tile;           // elements a tile; len <= tile: resident
  float t;            // max(temperature, 1e-6)
  float* buf;         // tile + 4 floats of shared memory
  uint64_t* bar;
  uint32_t phase;
  int pad;            // buf index of the tile's element 0

  // Bring elements [t0, t0 + n) into buf: the 16-byte aligned body by
  // bulk copy, the head and tail around it by plain loads. Element j lands
  // at buf[pad + j], pad the source's float offset in its 16 bytes, so an
  // aligned source lands at an aligned address.
  __device__ void load(int t0, int n) {
    const float* s = src + t0;
    const int p = static_cast<int>((reinterpret_cast<uintptr_t>(s) >> 2) & 3);
    const int head = min(n, (4 - p) & 3);
    const int body = (n - head) & ~3;
    // the previous tile is consumed, and the async proxy sees that
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      mbar_arrive_tx(bar, 4u * body);
      for (int off = 0; off < body; off += kCopyFloats)
        bulk_load(buf + p + head + off, s + head + off,
                  4 * min(kCopyFloats, body - off), bar);
    }
    for (int j = threadIdx.x; j < n - body; j += kThreads) {
      const int e = j < head ? j : j + body;
      buf[p + e] = s[e];
    }
    mbar_wait(bar, phase);
    phase ^= 1;
    __syncthreads();
    pad = p;
  }
};

// body(l, j) over the slice's elements, l = logit / t, j its index
template <class F>
__device__ void sweep(Slice& s, F&& body) {
  if (s.len <= s.tile) {
    for (int j = threadIdx.x; j < s.len; j += kThreads)
      body(s.buf[s.pad + j], j);
    return;
  }
  for (int t0 = 0; t0 < s.len; t0 += s.tile) {
    const int n = min(s.tile, s.len - t0);
    s.load(t0, n);
    for (int j = threadIdx.x; j < n; j += kThreads)
      body(s.buf[s.pad + j] / s.t, t0 + j);
  }
}

// One digit's pick: the bin of nb whose count (kMass = false) holds the
// target-th entry from the top, or (kMass = true) the lowest bin holding
// mass whose mass above is below the target (on the first digit computed
// here, from top_p and the row's total). The bins come in kGroups groups:
// every block has published its histogram (hist: nb low words, then nb
// high words) and its group totals (groups); after one cluster barrier
// every block gathers all blocks' group totals, takes the group, gathers
// that group's bins from all blocks and takes the bin. The same numbers
// in the same order in every block, so every block picks the same; each
// gather is one round trip of independent remote reads.
template <bool kMass>
__device__ Pick select_digit(cg::cluster_group& cl, Shared& sh,
                             uint32_t* hist, u64* groups, u64* table, int nb,
                             int C, u64 above, u64 target, bool first,
                             float top_p, long long* stamps) {
  constexpr int kLoads = kMaxCluster * kGroups / kThreads;
  const int lane = threadIdx.x & 31, per = nb / kGroups;
  stamp(stamps, sh);                     // the histogram
  cl.sync();                             // every block's histogram is in
  stamp(stamps, sh);                     // the barrier
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {     // table[r][g]: block r, group g
    const int i = threadIdx.x + k * kThreads;
    if (i < C * kGroups)
      table[i] = cl.map_shared_rank(groups, i / kGroups)[i % kGroups];
  }
  __syncthreads();
  if (threadIdx.x < 32) {                // the group: lane l holds groups
    u64 t[2] = {0, 0};                   // kGroups - 1 - 2l and the next
    for (int r = 0; r < C; ++r)
      for (int h = 0; h < 2; ++h) t[h] += table[r * kGroups + kGroups - 1 -
                                                2 * lane - h];
    const u64 s = t[0] + t[1];
    u64 inc = s;
    for (int off = 1; off < 32; off <<= 1) {
      const u64 o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    if (kMass && first)
      target = mass_target(top_p, __shfl_sync(0xffffffffu, inc, 31));
    u64 a = above + inc - s;             // above this lane's groups
    int got = -1;
    u64 got_above = 0;
    for (int h = 0; h < 2; ++h) {
      if (kMass ? t[h] != 0 && a < target
                : a < target && target <= a + t[h]) {
        got = kGroups - 1 - 2 * lane - h;   // mass: keep the lowest
        got_above = a;
      }
      a += t[h];
    }
    // mass: the lowest group, in the highest lane that found one; counting
    // finds one
    const unsigned hit = __ballot_sync(0xffffffffu, got >= 0);
    const int from = hit ? 31 - __clz(hit) : 0;
    const int g = __shfl_sync(0xffffffffu, got, from);
    const u64 ga = __shfl_sync(0xffffffffu, got_above, from);
    if (lane == 0) sh.pick = Pick{g, hit != 0, ga, target};
  }
  __syncthreads();
  stamp(stamps, sh);                     // the group's gather and pick
  const Pick pk = sh.pick;
  if (!pk.found) return pk;
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {     // table[r][j]: block r, bin j of
    const int i = threadIdx.x + k * kThreads;   // the group
    if (i < C * per) {
      const uint32_t* h = cl.map_shared_rank(hist, i / per);
      const int b = pk.bin * per + i % per;
      table[i] = kMass ? static_cast<u64>(h[nb + b]) << 32 | h[b] : h[b];
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {                // the bin: lane l holds bin
    u64 t = 0;                           // per - 1 - l of the group
    if (lane < per)
      for (int r = 0; r < C; ++r) t += table[r * per + per - 1 - lane];
    u64 inc = t;
    for (int off = 1; off < 32; off <<= 1) {
      const u64 o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    const u64 a = pk.above + inc - t;
    const bool ok = lane < per && (kMass ? t != 0 && a < pk.target
                                         : a < pk.target && pk.target <= a + t);
    const unsigned hit = __ballot_sync(0xffffffffu, ok);
    const int from = hit ? 31 - __clz(hit) : 0;
    const u64 ba = __shfl_sync(0xffffffffu, a, from);
    if (lane == 0)
      sh.pick = Pick{pk.bin * per + per - 1 - from, hit != 0, ba, pk.target};
  }
  __syncthreads();
  stamp(stamps, sh);                     // the bin's gather and pick
  return sh.pick;
}

// The shared memory a select works in: two histograms and two sets of
// group totals, a digit's in the one its parity names (a block may start
// a digit while a slower one still reads its previous one), and the table
// the gathers fill.
struct SelectMem {
  uint32_t* hist;     // [2][2 * nb max]
  u64* groups;        // [2][kGroups]
  u64* table;         // [cluster][kGroups]
  long long* stamps;  // phase stamps, or null
  int nb_max;
  int digit;          // digits taken so far, in both selects
};

// The key of the row's threshold, digit by digit; *found is false when no
// bin qualified (top-p: nothing is kept). Counting takes the target-th key
// from the top; weighing counts only keys >= floor_key of finite l.
template <bool kMass>
__device__ uint32_t radix_select(cg::cluster_group& cl, Shared& sh,
                                 Slice& s, SelectMem& m, const Plan& plan,
                                 u64 target, uint32_t floor_key, float maxl,
                                 float top_p, bool* found) {
  const float scale = __uint_as_float((127u + plan.shift) << 23);
  uint32_t prefix = 0;
  int done = 0;
  u64 above = 0;
  for (int d = 0; d < kDigits; ++d, ++m.digit) {
    const int w = plan.bits[d], nb = 1 << w, low = 32 - done - w;
    uint32_t* hist = m.hist + (m.digit & 1) * 2 * m.nb_max;
    u64* groups = m.groups + (m.digit & 1) * kGroups;
    for (int b = threadIdx.x; b < (kMass ? 2 : 1) * nb; b += kThreads)
      hist[b] = 0;                       // counts use the low words only
    __syncthreads();
    sweep(s, [&](float l, int) {
      const uint32_t key = key_of(l);
      if (done && (key >> (32 - done)) != prefix) return;
      const int b = (key >> low) & (nb - 1);
      if (!kMass) {
        atomicAdd(&hist[b], 1u);
        return;
      }
      if (key < floor_key || l == -CUDART_INF_F) return;
      const u64 v = __float2ull_rn(expf(l - maxl) * scale);
      if (v) hist_add(hist, hist + nb, b, v);
    });
    __syncthreads();
    // this block's group totals: 8 threads a group, nb / 512 bins each
    const int run = nb / kThreads, first = threadIdx.x * run;
    u64 x = 0;
    for (int b = first; b < first + run; ++b)
      x += kMass ? static_cast<u64>(hist[nb + b]) << 32 | hist[b] : hist[b];
    for (int off = 1; off < kThreads / kGroups; off <<= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (threadIdx.x % (kThreads / kGroups) == 0)
      groups[threadIdx.x / (kThreads / kGroups)] = x;
    const Pick p = select_digit<kMass>(cl, sh, hist, groups, m.table, nb,
                                       plan.cluster, above, target, d == 0,
                                       top_p, m.stamps);
    if (!p.found) {
      *found = false;
      return 0;
    }
    prefix = (prefix << w) | static_cast<uint32_t>(p.bin);
    done += w;
    above = p.above;
    target = p.target;
  }
  *found = true;
  return prefix;
}

__global__ void __launch_bounds__(kThreads, 2)
sample_prep_kernel(const float* __restrict__ logits,
                   const float* __restrict__ temps,
                   const float* __restrict__ top_ps,
                   float* __restrict__ masked, int* __restrict__ amax, int V,
                   int top_k, Plan plan, long long* __restrict__ stamps) {
  extern __shared__ __align__(128) unsigned char dyn[];
  __shared__ Shared sh;
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank()), row = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  SelectMem m;
  m.nb_max = 1 << max_bits(plan);
  m.hist = reinterpret_cast<uint32_t*>(dyn);
  m.groups = reinterpret_cast<u64*>(m.hist + 4 * m.nb_max);
  m.table = m.groups + 2 * kGroups;
  m.stamps = stamps;
  m.digit = 0;
  const int begin = min(V, rank * plan.slice);
  Slice s;
  s.src = logits + static_cast<size_t>(row) * V + begin;
  s.dst = masked + static_cast<size_t>(row) * V + begin;
  s.len = min(V, begin + plan.slice) - begin;
  s.tile = plan.tile;
  s.t = fmaxf(temps[row], 1e-6f);
  s.buf = reinterpret_cast<float*>(m.table + plan.cluster * kGroups);
  s.bar = &sh.bar;
  s.phase = 0;
  s.pad = 0;
  if (threadIdx.x == 0) {
    mbar_init(&sh.bar, 1);
    mbar_init_fence();
    sh.stamps = 0;
  }
  __syncthreads();
  stamp(stamps, sh);                     // the start

  // the one read of the slice: argmax of the raw logits; a resident slice
  // keeps l = logit / t
  ArgMax best{-CUDART_INF_F, INT_MAX};
  if (s.len <= s.tile) {
    s.load(0, s.len);
    for (int j = threadIdx.x; j < s.len; j += kThreads) {
      float& e = s.buf[s.pad + j];
      best = better(best, ArgMax{e, begin + j});
      e = e / s.t;
    }
  } else {
    for (int t0 = 0; t0 < s.len; t0 += s.tile) {
      const int n = min(s.tile, s.len - t0);
      s.load(t0, n);
      for (int j = threadIdx.x; j < n; j += kThreads)
        best = better(best, ArgMax{s.buf[s.pad + j], begin + t0 + j});
    }
  }
  stamp(stamps, sh);                     // the load
  best = warp_argmax(best);
  if (lane == 0) sh.am[warp] = best;
  __syncthreads();
  if (warp == 0) {
    ArgMax b{-CUDART_INF_F, INT_MAX};
    if (lane < kWarps) b = sh.am[lane];
    b = warp_argmax(b);
    if (lane == 0) sh.slice_best = b;
  }
  cl.sync();
  if (warp == 0) {
    ArgMax b{-CUDART_INF_F, INT_MAX};
    if (lane < plan.cluster) b = *cl.map_shared_rank(&sh.slice_best, lane);
    b = warp_argmax(b);
    if (lane == 0) sh.row_best = b;
  }
  __syncthreads();
  const ArgMax rb = sh.row_best;
  if (rank == 0 && threadIdx.x == 0) amax[row] = rb.i;
  const float maxl = rb.v / s.t;  // the division is monotone: max of l
  stamp(stamps, sh);                     // the argmax round

  bool found;
  uint32_t floor_key = 0;         // keys below it are masked by top-k
  if (top_k > 0 && top_k < V)
    floor_key = radix_select<false>(cl, sh, s, m, plan,
                                    static_cast<u64>(top_k), 0u, maxl, 0.f,
                                    &found);
  const float top_p = top_ps[row];
  uint32_t cut = key_of(CUDART_INF_F);   // top_p <= 0: nothing kept
  if (top_p > 1.f) {
    cut = 0;                             // everything kept
  } else if (top_p > 0.f) {
    const uint32_t k = radix_select<true>(cl, sh, s, m, plan, 0,
                                          floor_key, maxl, top_p, &found);
    if (found) cut = k;
  }
  // the cluster's last reads of this block's shared memory are done once
  // every block has arrived; the write pass needs only its own
  cluster_arrive();
  const uint32_t keep = max(floor_key, cut);
  sweep(s, [&](float l, int j) {
    s.dst[j] = key_of(l) < keep ? -CUDART_INF_F : l;
  });
  cluster_wait();
  stamp(stamps, sh);                     // the write
}

bool plan_ok(const Plan& p, int V) {
  int sum = 0;
  for (int d = 0; d < kDigits; ++d) {
    if ((1 << p.bits[d]) < kThreads || p.bits[d] > kMaxBits) return false;
    sum += p.bits[d];
  }
  int log2v = 0;
  while ((1ll << log2v) < V) ++log2v;
  return sum == 32 && p.cluster >= 1 && p.cluster <= kMaxCluster &&
         p.slice >= 1 && static_cast<long long>(p.cluster) * p.slice >= V &&
         p.tile >= 1 && p.tile <= p.slice && p.shift >= 0 &&
         p.shift + log2v <= 63 &&
         smem_bytes(p) <= static_cast<size_t>(kSmemLimit) - sizeof(Shared);
}

// allow the non-portable cluster of 16 and this much dynamic shared memory
cudaError_t configure(size_t smem) {
  static bool nonportable = false;
  static size_t allowed = 0;
  cudaError_t err = cudaSuccess;
  if (!nonportable) {
    err = cudaFuncSetAttribute(sample_prep_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    nonportable = true;
  }
  if (smem > allowed) {
    err = cudaFuncSetAttribute(sample_prep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  return err;
}

cudaLaunchConfig_t launch_config(const Plan& p, int B, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.cluster, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(p);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = p.cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// logits [B, V] f32; temps, top_ps [B] f32; masked [B, V] f32 and amax
// [B] int32 outputs; the plan's integers from `sample_plan(V)`; stamps
// null, or 2 * 32 int64 for the phase stamps. One launch: a cluster of
// `cluster` blocks a row.
extern "C" int fused_sample_prep_fwd(const void* logits, const void* temps,
                                     const void* top_ps, void* masked,
                                     void* amax, int B, int V, int top_k,
                                     int cluster, int slice, int tile,
                                     int shift, int bits0, int bits1,
                                     int bits2, void* stamps, void* stream) {
  const Plan plan{cluster, slice, tile, shift, {bits0, bits1, bits2}};
  if (B < 1 || B > 65535 || V < 1 || !plan_ok(plan, V))
    return cudaErrorInvalidValue;
  cudaError_t err = configure(smem_bytes(plan));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config(plan, B, static_cast<cudaStream_t>(stream), &attr);
  err = cudaLaunchKernelEx(&cfg, sample_prep_kernel,
                           static_cast<const float*>(logits),
                           static_cast<const float*>(temps),
                           static_cast<const float*>(top_ps),
                           static_cast<float*>(masked),
                           static_cast<int*>(amax), V, top_k, plan,
                           static_cast<long long*>(stamps));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// dynamic shared memory a block of this plan takes
extern "C" int fused_sample_smem(int cluster, int tile, int bits0, int bits1,
                                 int bits2) {
  const Plan plan{cluster, tile, tile, 0, {bits0, bits1, bits2}};
  return static_cast<int>(smem_bytes(plan));
}

// clusters of this plan the card holds at once (cudaOccupancyMaxActive-
// Clusters), or minus the CUDA error
extern "C" int fused_sample_max_clusters(int cluster, int slice, int tile,
                                         int bits0, int bits1, int bits2) {
  const Plan plan{cluster, slice, tile, 0, {bits0, bits1, bits2}};
  cudaError_t err = configure(smem_bytes(plan));
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(plan, 1, nullptr, &attr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, sample_prep_kernel, &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
