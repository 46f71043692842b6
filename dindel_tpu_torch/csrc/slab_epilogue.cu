// The slab program's epilogue after the pair-HMM DP, for NVIDIA Hopper
// (sm_90a): the bMid-slice folds and MAP backtrack (finish), the per-pair
// MAP-path statistics (pair_stats) and the per-window diploid read folds
// (window_call).
//
// Replaces the device loops of the JAX package's slab program (XLA
// `lax.scan`s, no Pallas):
// - finish:      dindel_tpu/hmm/batch.py `_finish` (:249; the exact fold
//                scan :311, the backtrack scans :358 down and :367 up);
// - pair_stats:  dindel_tpu/hmm/batch.py `_pair_stats` (:1823; the
//                m_log_bq scan :1881, the n_ind scan :1908, the per-slot
//                coverage loop :1923);
// - window_call: dindel_tpu/infer/device_call.py `_window_call` (:232;
//                the read scan :265).
// Bound to PyTorch by ctypes through the plain C entry points at the end
// (dindel_tpu_torch/hmm/epilogue_kernel.py); the plain PyTorch versions
// they are held to are hmm/finish.py, hmm/stats.py and
// infer/device_call.py `window_call`.
//
// What bounds each on this card, and what its design does about it:
// - finish reads five (B, 2(H_pad+2)) rows once (175 MB at an engine
//   slab of 24576 pairs, float32), then walks each pair's MAP path: one
//   byte a step from backpointer planes far larger than L2, each step in
//   a 32-byte sector of its own, its row chosen by the step before.  The
//   fold is bound by bytes, the walks by the rate of random sectors and
//   their latency.  A block takes P pairs, P from B (the grid holds four
//   to eight blocks an SM, from a streaming window's ~1000 pairs to an
//   engine slab).  The fold runs a warp per pair: lane l reads columns
//   l, l+32, ... of the five rows (every load coalesced), folds them in
//   order, and the lanes' partial folds combine by warp shuffles under
//   the sequential fold's rule (below).  The exact EPS fold is
//   order-dependent, but only a column above every earlier one (a
//   record) can be taken, so per 32 columns the warp finds the records
//   with a shuffle max-scan and runs the sequential EPS test over them
//   alone.  The walks run one thread per (pair, direction): the down walk
//   through btf and the up walk through btb start together from s_mid,
//   so a pair's chain is max(a, rl-1-a) steps instead of their sum, and
//   the 2P chains of every resident block are in flight at once.
//   map_state rows are built in shared memory and written coalesced.
// - pair_stats reads, per pair, its map_state row, its read's four table
//   rows (codes, bqt and q95 flags, float64 log10q) and its hap's codes
//   (1.9 kB a pair at an engine slab, 16.5 MB of distinct bytes: reads
//   are shared by a window's haps and haps by its reads), and does a few
//   integer operations per column.  It is bound by the rate it issues
//   instructions and by its loads' latency, not by HBM (PERF.md has the
//   phases' times).  A block takes P pairs (P from B, as finish's).  It
//   stages their scalars, then warp w stages pairs w, w + kStatWarps,
//   ... into shared memory with asynchronous copies (cp.async, 16 bytes
//   a lane where the rows are aligned), all in flight at once; a hap's
//   codes and slot tables once for each run of pairs with that hap
//   (consecutive pairs mostly share one: copied once a pair, the same
//   few L2 lines served hundreds of requests at a time).  Then, per
//   pair, lane l decodes columns l, l+32, ... from shared memory in one
//   pass: the order-free counts are lane partial sums or ballot counts
//   (a chunk with no mismatch skips the mismatch counts); n_ind, a
//   sequential scan, is counted per 32 columns from ballot masks with a
//   carry between chunks (below; a chunk with no ins column and no
//   deletion skips it); each column is left decoded in place (hap
//   position and mismatch bits), so the V slot tests, kSlotGroup slots
//   a pass, read one word a column.  The float64 m_log_bq sum keeps
//   column order: after the block's warps are done, thread p adds pair
//   p's terms from shared memory, walking the pass's ballot masks of
//   bqt, so the P chains run in parallel.  Outputs are staged in shared
//   memory and written with consecutive threads on consecutive pairs.
// - window_call is bound by latency: its bytes take a fraction of a
//   launch, and each output is a chain of one dependent add per read
//   (the read order is the contract): nr_w adds at four clocks each at
//   least.  A block takes one window and KT of its pairs, KT from the
//   shape (one wave of blocks).  Per chunk of R reads it computes t[k, r]
//   once for each of its pairs and reads, in parallel (a thread gathers
//   several at once: their index loads, then their ll loads), into
//   shared memory; then each of the (S+1) x KT accumulators adds the
//   chunk's values in read order, the next values' loads issued ahead of
//   the adds, its sum carried across chunks.  The exp/log work is done
//   once per (pair, read), not S+1 times, and the serial chain is one
//   shared-memory add per read.  Each accumulator's seed is loaded at the
//   start into a register, so that its latency overlaps the gathers'.
//   Staging each hap's ll values in shared memory first (once per hap
//   and read, not twice per pair) measured slower on this card: the
//   gathers hit L2, and the staging adds a barrier and a shared-memory
//   round to a latency-bound launch (PERF.md).
//
// Numerics (the contract of the plain versions):
// - finish: base = (alpha + obs) + beta, vr = base + prior_rmq,
//   vh = base + prior_hmq, in the tensors' type and that association.
//   The fast fold is a first-occurrence argmax: a NaN beats any number
//   and the first NaN wins (torch.argmax/amax's rule), else the larger
//   value wins, and of equal values (+0.0 and -0.0 included) the lower
//   column: the value and index the sequential strict-`>` fold from
//   -inf keeps; the lanes' partial folds combine under that order, which
//   does not depend on how the columns are split.  The exact fold takes
//   `v > ll + EPS` (EPS in the tensors' type) in column order over the
//   records; its ll_off/ll_on folds take a strict `>` and never a NaN,
//   combined first-occurrence too.  The walks decode the 4-bit class codes as
//   finish.py does, with a floor modulo (PyTorch's `%` on the state), so
//   a garbage code never indexes outside its row.
// - pair_stats: integer counts, and m_log_bq summed in column order in
//   float64 with masked terms added as +0.0.  The kernel skips them:
//   the sum starts at +0.0 and never becomes -0.0 under round to
//   nearest (+0.0 + -0.0 and an exact cancellation both give +0.0), and
//   adding +0.0 to any other value (NaN and +-inf included) returns it
//   unchanged.  n_ind: an event is a column b with del_ev, or an ins-on
//   column with no ins-on column earlier in its run of ins columns; it
//   is new unless the last event before it has its hap position.  Per
//   32 columns, lane b finds its run's start from the ballot of non-ins
//   columns and the last event before it from the ballot of events; the
//   run's "seen" flag and the last event's position carry to the next
//   chunk, so the count equals the sequential scan's.
// - window_call: t = log(.5) + (m + log(1 + exp(mn - m))) with expf/logf
//   (exp/log in double), added in read order.  Reads at and past nr_w
//   add +0.0 in the plain version; x + 0.0 + 0.0 == x + 0.0 bit for bit
//   (only -0.0 changes, once), so the kernel adds one +0.0 when a window
//   has such reads.  Build with -fmad=false and without --use_fast_math.
//
// Built once per (type, fold) translation unit: DINDEL_EPI_DOUBLE and
// DINDEL_EPI_EXACT select them.  Each exports its finish entry point;
// the fast-fold units export window_call for their type, and the float32
// fast unit exports pair_stats (which has no type or fold) and the empty
// launch that times the launch floor.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#ifndef DINDEL_EPI_DOUBLE
#define DINDEL_EPI_DOUBLE 0
#endif
#ifndef DINDEL_EPI_EXACT
#define DINDEL_EPI_EXACT 0
#endif

namespace {

constexpr double kEPS = 1e-10;  // ObservationModelFB.hpp:25
constexpr int kBig = 2147483647;  // fb's empty-min sentinel (stats.py)
constexpr unsigned kFull = 0xffffffffu;

// pair_stats: warps a block (a warp per pair at a time), most pairs a
// block (its m_log_bq sums run one thread per pair in one warp, its hap
// runs are one ballot), slots tested per pass over a row
constexpr int kStatWarps = 4;
constexpr int kStatThreads = 32 * kStatWarps;
constexpr int kStatMaxPairs = 32;
constexpr int kSlotGroup = 4;
constexpr int kStatMaxLPad = 32736;  // slot counts: 10 bits a lane
constexpr int kStatMaxHPad = 1 << 28;    // 2 xs + ins in an int

// finish: warps a block; a walk thread per (pair, direction), so at most
// kFinThreads / 2 pairs a block
constexpr int kFinWarps = 4;
constexpr int kFinThreads = 32 * kFinWarps;
constexpr int kFinMaxPairs = kFinThreads / 2;
constexpr int kUnroll = 4;  // columns a lane loads before it folds them

// window_call: threads a block, blocks an SM it is built to keep
// resident (at most 64 registers a thread; window_shape plans one wave
// of them), t values a chunk holds (KT x R), t values a thread gathers
// at once
constexpr int kWinThreads = 256;
constexpr int kWinBlocksPerSM = 4;
constexpr int kWinTile = 4096;
constexpr int kGather = 4;

constexpr int kStaticSmem = 48 * 1024;   // above: dynamic, by attribute
constexpr int kMaxSmem = 227 * 1024;     // a block's most on sm_90

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float lg(float v) { return logf(v); }
__device__ __forceinline__ double lg(double v) { return log(v); }

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// the state before `cur` on the forward (Dec) pass's path, from the code
// c of `cur` at column x = cur mod SP
__device__ __forceinline__ int prev_fwd(int c, int cur, int x, int SP,
                                        int RO, int hl) {
  if (cur >= SP) return c == 0 ? cur : x;
  if (x == RO) return c == 0 ? SP + RO : c == 1 ? SP + hl : c == 2 ? RO : hl;
  return c == 0 ? SP + max(x - 1, 0) : c == 1 ? x : max(x - (c - 1), 0);
}

// the state after `cur` on the backward (Inc) pass's path
__device__ __forceinline__ int next_bwd(int c, int cur, int x, int SP,
                                        int RO, int hl, int numT) {
  if (cur >= SP) {
    const int x1 = x + 1 <= hl ? x + 1 : RO;
    return c == 0 ? cur : c == 1 ? x : x1;
  }
  const int xy = x + (numT - c);
  return c == 0 ? SP + x : c == numT ? x : (xy <= hl ? xy : RO);
}

// Does (v, i) come before (cv, ci) in a fold's order?  Fast fold: a NaN
// before any number, then the larger value, then the lower column (for
// two NaNs too).  Exact fold's ll_off/ll_on: the larger value, then the
// lower column; a NaN never.  From (-inf, kBig), a lane that folds its
// columns in order with these keeps what the sequential fold keeps for
// them; any split of the columns, combined with them, keeps the same.
template <typename T>
__device__ __forceinline__ bool before_fast(T v, int i, T cv, int ci) {
  const bool n = is_nan(v), cn = is_nan(cv);
  if (n != cn) return n;
  if (!n && v != cv) return v > cv;
  return i < ci;
}

template <typename T>
__device__ __forceinline__ bool before_exact(T v, int i, T cv, int ci) {
  return v > cv || (v == cv && i < ci);
}

template <typename T, bool EXACT>
__device__ __forceinline__ void fold_into(T v, int i, T* cv, int* ci) {
  if (EXACT ? before_exact(v, i, *cv, *ci) : before_fast(v, i, *cv, *ci)) {
    *cv = v;
    *ci = i;
  }
}

// every lane ends with the warp's first (value, column) in the order
template <typename T, bool EXACT>
__device__ __forceinline__ void warp_fold(T* v, int* i) {
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, *v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, *i, o);
    fold_into<T, EXACT>(ov, oi, v, i);
  }
}

// finish's shared memory, P pairs a block: the fold results (3P values,
// P s_mid, 2P flags) and the map_state rows (P x LS, LS = L_pad | 1 so
// that rows start in different banks)
struct FinishSmem {
  int P, LS;
  size_t elem;
  __host__ __device__ size_t ints_at() const { return 3 * (size_t)P * elem; }
  __host__ __device__ size_t bytes_at() const {
    return ints_at() + ((size_t)P + (size_t)P * LS) * 4;
  }
  __host__ __device__ size_t total() const { return bytes_at() + 2 * P; }
};

// the column of state `cur` (a floor modulo, fast for 0 <= cur < 2 SP)
__device__ __forceinline__ int state_col(int cur, int SP) {
  if ((unsigned)cur < (unsigned)SP) return cur;
  if ((unsigned)(cur - SP) < (unsigned)SP) return cur - SP;
  return floor_mod(cur, SP);
}

template <typename T>
__device__ __forceinline__ T max_num(T a, T b) {  // a NaN never wins
  return is_nan(b) ? a : (is_nan(a) || b > a) ? b : a;
}

// One 32-column sub-row of the exact EPS fold, v at column base + lane
// (NaN past the row).  Only a strict prefix maximum can be taken: a
// taken v exceeds fl(ll + EPS) >= ll >= every earlier taken value, and
// every value not taken is <= fl(ll + EPS) at its step, which only grows.
// So the warp finds this sub-row's records (v above the maximum of every
// earlier column: `carry`, then a shuffle scan) and runs the sequential
// `v > ll + EPS` test over them alone, in column order; every lane
// carries the same (ll, idx, carry).
template <typename T>
__device__ __forceinline__ void eps_records(T v, int base, int lane, T eps,
                                            T* carry, T* ll, int* idx) {
  T s = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T t = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s = max_num(s, t);
  }
  T before = __shfl_up_sync(0xffffffffu, s, 1);
  before = max_num(lane ? before : T(-INFINITY), *carry);
  unsigned rec = __ballot_sync(0xffffffffu, v > before);
  *carry = max_num(*carry, __shfl_sync(0xffffffffu, s, 31));
  while (rec) {
    const int j = __ffs(rec) - 1;
    rec &= rec - 1;
    const T val = __shfl_sync(0xffffffffu, v, j);
    if (val > *ll + eps) {
      *ll = val;
      *idx = base + j;
    }
  }
}

// The fold state of one lane: its first (value, column) for ll, ll_hmq
// (the fast fold's; the exact fold's come from eps_records), ll_off and
// ll_on; `column` folds column x, whose x mod SP is xm.
template <typename T, bool EXACT>
struct Fold {
  T ll, llH, off, on;
  int ir, ih, io, in;
  __device__ __forceinline__ void column(T v, T w, int x, int xm, int RO) {
    if (!EXACT) {
      fold_into<T, false>(v, x, &ll, &ir);
      fold_into<T, false>(w, x, &llH, &ih);
    }
    if (xm == 0)
      fold_into<T, EXACT>(v, x, &off, &io);
    else if (xm != RO)
      fold_into<T, EXACT>(v, x, &on, &in);
  }
};

__device__ __forceinline__ int wrap(int xm, int SP) {
  while (xm >= SP) xm -= SP;
  return xm;
}

// P pairs a block.  Fold: warp `warp` folds pairs warp, warp + kFinWarps,
// ...; walks: thread t < P walks pair t down btf, thread P + t walks it
// up btb, all starting once the block's folds are done.  read_len may be
// null: the up walk then runs to L_pad-2 as the plain version does; else
// it stops at the pair's last read column and the columns past it hold
// the last state (the plain version decodes unwritten rows there).
template <typename T, bool EXACT>
__global__ void __launch_bounds__(kFinThreads)
finish_kernel(const int* __restrict__ b_mid, const int* __restrict__ hap_len,
              const int* __restrict__ read_len, const T* __restrict__ alpha,
              const T* __restrict__ beta, const T* __restrict__ obs,
              const T* __restrict__ prior_rmq,
              const T* __restrict__ prior_hmq,
              const uint8_t* __restrict__ btf,
              const uint8_t* __restrict__ btb, T* __restrict__ fl,
              uint8_t* __restrict__ fb, int* __restrict__ map_state, int B,
              int H_pad, int L_pad, int numT, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const FinishSmem lay{P, L_pad | 1, sizeof(T)};
  T* fl_s = reinterpret_cast<T*>(smem);
  int* smid_s = reinterpret_cast<int*>(smem + lay.ints_at());
  int* ms_s = smid_s + P;
  uint8_t* fb_s = smem + lay.bytes_at();

  const int SP = H_pad + 2, S = 2 * SP, RO = H_pad + 1;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int i0 = blockIdx.x * P;
  const int np = min(P, B - i0);
  const T neginf = T(-INFINITY);
  const T eps = T(kEPS);

  for (int p = warp; p < np; p += kFinWarps) {
    const size_t row = (size_t)(i0 + p) * S;
    const T *ra = alpha + row, *rb = beta + row, *ro = obs + row,
            *rr = prior_rmq + row, *rh = prior_hmq + row;
    Fold<T, EXACT> f{neginf, neginf, neginf, neginf, kBig, kBig, kBig, kBig};
    T cv = neginf, cw = neginf;  // exact fold: the maxima so far
    // lane l takes column l of each 32
    int xm = wrap(lane, SP);
    for (int b0 = 0; b0 < S; b0 += 32 * kUnroll) {
      T va[kUnroll], vb[kUnroll], vo[kUnroll], vr[kUnroll], vh[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = b0 + 32 * u + lane;
        if (x < S) {
          va[u] = ra[x];
          vb[u] = rb[x];
          vo[u] = ro[x];
          vr[u] = rr[x];
          vh[u] = rh[x];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int x = b0 + 32 * u + lane;
        if (EXACT && b0 + 32 * u >= S) break;  // warp-uniform
        T v = T(NAN), w = T(NAN);
        if (x < S) {
          const T base = (va[u] + vo[u]) + vb[u];
          v = base + vr[u];
          w = base + vh[u];
          f.column(v, w, x, xm, RO);
          xm = wrap(xm + 32, SP);
        }
        if (EXACT) {
          eps_records(v, b0 + 32 * u, lane, eps, &cv, &f.ll, &f.ir);
          eps_records(w, b0 + 32 * u, lane, eps, &cw, &f.llH, &f.ih);
        }
      }
    }
    if (!EXACT) {
      warp_fold<T, false>(&f.ll, &f.ir);
      warp_fold<T, false>(&f.llH, &f.ih);
    }
    warp_fold<T, EXACT>(&f.off, &f.io);
    warp_fold<T, EXACT>(&f.on, &f.in);
    if (lane == 0) {
      // no column taken (every value -inf): the sequential fold's 0
      const int map_rmq = f.ir == kBig ? 0 : f.ir;
      const int s_mid = f.ih == kBig ? 0 : f.ih;
      const int xr = map_rmq % SP, xh = s_mid % SP;
      fl_s[p] = f.ll;
      fl_s[P + p] = f.off;
      fl_s[2 * P + p] = f.on;
      fb_s[p] = (xr == 0) | (xr == RO);
      fb_s[P + p] = (xh == 0) | (xh == RO);
      smid_s[p] = s_mid;
    }
  }
  __syncthreads();

  if (t < 2 * P) {
    const bool up = t >= P;
    const int p = up ? t - P : t;
    if (p < np) {
      const int i = i0 + p;
      const int hl = hap_len[i];
      const int rl = read_len ? read_len[i] : L_pad;
      // the anchor column: map_state is the down walk left of it, the up
      // walk right of it
      const int a = min(max(b_mid[i], 0), L_pad - 1);
      // down: column b-1 from btf row b-1, b = a..1; up: column b+1 from
      // btb row b, b = a..min(L_pad-2, rl-2)
      const int n = up ? max(0, min(L_pad - 2, rl - 2) - a + 1) : a;
      const int d = up ? 1 : -1;
      int row = up ? a : a - 1;
      int col = row + (up ? 1 : 0);
      const uint8_t* bt = (up ? btb : btf) + (size_t)i * SP;
      const size_t rstride = (size_t)B * SP;
      int* ms = ms_s + p * lay.LS;
      int cur = smid_s[p];
      if (up) ms[a] = cur;
      for (int k = 0; k < n; ++k) {
        const int x = state_col(cur, SP);
        const int pack = bt[(size_t)row * rstride + x];
        const int c = (cur >= SP ? pack >> 4 : pack) & 15;
        cur = up ? next_bwd(c, cur, x, SP, RO, hl, numT)
                 : prev_fwd(c, cur, x, SP, RO, hl);
        ms[col] = cur;
        row += d;
        col += d;
      }
      if (up)
        for (; col < L_pad; ++col) ms[col] = cur;
    }
  }
  __syncthreads();

  int* out = map_state + (size_t)i0 * L_pad;
  for (int e = t; e < np * L_pad; e += kFinThreads) {
    const int p = e / L_pad;
    out[e] = ms_s[p * lay.LS + (e - p * L_pad)];
  }
  for (int p = t; p < np; p += kFinThreads) {
    fl[i0 + p] = fl_s[p];
    fl[B + i0 + p] = fl_s[P + p];
    fl[2 * B + i0 + p] = fl_s[2 * P + p];
    fb[i0 + p] = fb_s[p];
    fb[B + i0 + p] = fb_s[P + p];
  }
}

// pair_stats's shared memory, P pairs a block.  A pair's region holds
// its map_state row (decoded in place by the column pass; zeros past
// L_pad, a state that decodes to no column), its read's log10q, code,
// bqt and q95 rows, its hap's codes and the pass's ballot masks of bqt,
// each 16-byte aligned, the map_state and byte rows padded to whole
// chunks of 32 columns; a region is an odd number of 16-byte units, so
// that the sum threads (a pair each) start in different banks.  Then
// the block's m_log_bq output, the pairs' read and hap rows, the ints
// outputs, the pairs' read and hap lengths, the slot tables (P x V:
// left, right, isdel | valid << 1; of a run's first pair, see
// StatsBlock), the byte outputs (flags, cov_ok) and the pairs'
// off_hap_hmq.
struct StatsSmem {
  int P, L_pad, H_pad, V;
  __host__ __device__ static size_t a16(size_t n) {
    return (n + 15) & ~(size_t)15;
  }
  __host__ __device__ int nch() const { return (L_pad + 31) / 32; }
  __host__ __device__ size_t cols() const { return 32 * (size_t)nch(); }
  __host__ __device__ size_t lq_at() const { return 4 * cols(); }
  __host__ __device__ size_t rc_at() const {
    return lq_at() + a16(8 * (size_t)L_pad);
  }
  __host__ __device__ size_t bq_at() const { return rc_at() + cols(); }
  __host__ __device__ size_t q95_at() const { return bq_at() + cols(); }
  __host__ __device__ size_t hc_at() const { return q95_at() + cols(); }
  __host__ __device__ size_t mask_at() const { return hc_at() + a16(H_pad); }
  __host__ __device__ size_t pair_bytes() const {
    const size_t n = mask_at() + a16(4 * (size_t)nch());
    return (n / 16) % 2 ? n : n + 16;
  }
  __host__ __device__ size_t mlq_at() const {
    return (size_t)P * pair_bytes();
  }
  __host__ __device__ size_t ri_at() const { return mlq_at() + 8 * (size_t)P; }
  __host__ __device__ size_t hi_at() const { return ri_at() + 8 * (size_t)P; }
  __host__ __device__ size_t ints_at() const {
    return hi_at() + 8 * (size_t)P;
  }
  __host__ __device__ size_t rl_at() const {
    return ints_at() + 32 * (size_t)P;
  }
  __host__ __device__ size_t hl_at() const { return rl_at() + 4 * (size_t)P; }
  __host__ __device__ size_t left_at() const {
    return hl_at() + 4 * (size_t)P;
  }
  __host__ __device__ size_t right_at() const {
    return left_at() + 4 * (size_t)P * V;
  }
  __host__ __device__ size_t sflag_at() const {
    return right_at() + 4 * (size_t)P * V;
  }
  __host__ __device__ size_t flags_at() const {
    return sflag_at() + (size_t)P * V;
  }
  __host__ __device__ size_t cov_at() const {
    return flags_at() + 2 * (size_t)P;
  }
  __host__ __device__ size_t off_at() const {
    return cov_at() + (size_t)P * V;
  }
  __host__ __device__ size_t total() const { return off_at() + (size_t)P; }
};

// n bytes from global `src` to shared `dst` (16-byte aligned) by the
// warp's lanes: asynchronous copies of 16 or 4 bytes where src and n
// allow, else byte by byte
__device__ __forceinline__ void warp_stage(void* dst, const void* src, int n,
                                           int lane) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  const unsigned a = (unsigned)reinterpret_cast<uintptr_t>(src) | (unsigned)n;
  if ((a & 15) == 0) {
#pragma unroll 1
    for (int k = 16 * lane; k < n; k += 16 * 32)
      __pipeline_memcpy_async(d + k, s + k, 16);
  } else if ((a & 3) == 0) {
#pragma unroll 1
    for (int k = 4 * lane; k < n; k += 4 * 32)
      __pipeline_memcpy_async(d + k, s + k, 4);
  } else {
#pragma unroll 1
    for (int k = lane; k < n; k += 32) d[k] = s[k];
  }
}

// the hap position xs of state m (stats.py: m mod SP, RO read as hl +
// 1); a floor modulo for codes outside [0, 2 SP)
__device__ __forceinline__ int stat_xs(int m, int SP, int RO, int hl) {
  int xa = m >= SP ? m - SP : m;
  if ((unsigned)m >= (unsigned)(2 * SP)) xa = floor_mod(m, SP);
  return xa == RO ? hl + 1 : xa;
}

// One block of pair_stats: pairs i0 .. i0 + np - 1, their scalars in
// shared memory.  Warp w takes pairs w, w + kStatWarps, ...: npw of
// them.  Consecutive pairs mostly share a hap (a slab's pairs are hap
// major within a window), so its codes and slot tables are staged once
// for each run of pairs with one hap, by the run's first pair (a bit of
// `first`), and read from there.  The phases are the kernel's.
struct StatsBlock {
  unsigned char* smem;
  StatsSmem lay;
  int i0, np, w, lane, npw, SP, RO;
  unsigned first;

  __device__ StatsBlock(unsigned char* s, const StatsSmem& l, int B)
      : smem(s),
        lay(l),
        i0(blockIdx.x * l.P),
        w(threadIdx.x >> 5),
        lane(threadIdx.x & 31),
        SP(l.H_pad + 2),
        RO(l.H_pad + 1),
        first(0) {
    np = min(lay.P, B - i0);
    npw = np > w ? (np - w + kStatWarps - 1) / kStatWarps : 0;
  }

  __device__ __forceinline__ unsigned char* region(int p) const {
    return smem + (size_t)p * lay.pair_bytes();
  }
  template <typename T>
  __device__ __forceinline__ T* at(size_t off) const {
    return reinterpret_cast<T*>(smem + off);
  }
  // the first pair of pair p's run (whose region holds its hap's codes)
  __device__ __forceinline__ int run_start(int p) const {
    return 31 - __clz(first & (0xffffffffu >> (31 - p)));
  }

  // phase 1: the pairs' scalars (a thread a pair); then each warp's
  // pairs' rows into their regions, all in flight at once, and the runs'
  // hap codes and slot tables; returns when the block's copies have
  // landed
  __device__ __forceinline__ void stage(
      const int* __restrict__ map_state, const int* __restrict__ read_len,
      const int* __restrict__ hap_len, const int64_t* __restrict__ read_idx,
      const int64_t* __restrict__ hap_idx,
      const uint8_t* __restrict__ read_codes_r,
      const uint8_t* __restrict__ hap_codes_h,
      const uint8_t* __restrict__ bqt_r, const uint8_t* __restrict__ q95_r,
      const double* __restrict__ log10q_r, const int* __restrict__ v_left_h,
      const int* __restrict__ v_right_h,
      const uint8_t* __restrict__ v_isdel_h,
      const uint8_t* __restrict__ v_valid_h,
      const uint8_t* __restrict__ off_hap_hmq) {
    const int L = lay.L_pad, V = lay.V, t = threadIdx.x;
    long long* ri = at<long long>(lay.ri_at());
    long long* hi = at<long long>(lay.hi_at());
    if (t < np) {
      ri[t] = read_idx[i0 + t];
      hi[t] = hap_idx[i0 + t];
      at<int>(lay.rl_at())[t] = read_len[i0 + t];
      at<int>(lay.hl_at())[t] = hap_len[i0 + t];
      at<uint8_t>(lay.off_at())[t] = off_hap_hmq[i0 + t] != 0;
    }
    __syncthreads();
    first = __ballot_sync(kFull,
                          lane < np && (lane == 0 || hi[lane] != hi[lane - 1]));
    for (int k = 0; k < npw; ++k) {
      const int p = w + kStatWarps * k;
      const long long r = ri[p];
      unsigned char* reg = region(p);
      warp_stage(reg, map_state + (size_t)(i0 + p) * L, 4 * L, lane);
      warp_stage(reg + lay.lq_at(), log10q_r + r * L, 8 * L, lane);
      warp_stage(reg + lay.rc_at(), read_codes_r + r * L, L, lane);
      warp_stage(reg + lay.bq_at(), bqt_r + r * L, L, lane);
      warp_stage(reg + lay.q95_at(), q95_r + r * L, L, lane);
      for (int c = L + lane; c < (int)lay.cols(); c += 32)
        reinterpret_cast<int*>(reg)[c] = 0;
      if ((first >> p) & 1) {
        const long long h = hi[p];
        warp_stage(reg + lay.hc_at(), hap_codes_h + h * lay.H_pad,
                   lay.H_pad, lane);
        for (int v = lane; v < V; v += 32) {
          const long long slot = h * V + v;
          at<int>(lay.left_at())[p * V + v] = v_left_h[slot];
          at<int>(lay.right_at())[p * V + v] = v_right_h[slot];
          at<uint8_t>(lay.sflag_at())[p * V + v] =
              (v_isdel_h[slot] != 0) | (v_valid_h[slot] != 0) << 1;
        }
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }

  // phase 2: each warp's pairs, one at a time: the column pass, then
  // the slot tests
  __device__ __forceinline__ void pairs(int max_mismatch) {
    for (int k = 0; k < npw; ++k) {
      const int p = w + kStatWarps * k;
      pass(p, at<int>(lay.rl_at())[p], at<int>(lay.hl_at())[p],
           at<uint8_t>(lay.off_at())[p] != 0, max_mismatch);
    }
  }

  // pair p's column pass (lane l: columns l, l+32, ...) and slot tests
  __device__ __forceinline__ void pass(int p, int rl_p, int hl_p, bool off_p,
                                       int max_mismatch) {
    const int H_pad = lay.H_pad, P = lay.P, nch = lay.nch();
    unsigned char* reg = region(p);
    int* ms = reinterpret_cast<int*>(reg);
    const uint8_t* rc = reg + lay.rc_at();
    const uint8_t* bq = reg + lay.bq_at();
    const uint8_t* q95 = reg + lay.q95_at();
    const int p0 = run_start(p);
    const uint8_t* hc = region(p0) + lay.hc_at();
    unsigned* masks = reinterpret_cast<unsigned*>(reg + lay.mask_at());
    const unsigned below = (1u << lane) - 1, hlu = (unsigned)max(hl_p, 0);

    int fbv = kBig, lbv = -1, seen = 0, has_prev = 0, any_mm = 0;
    int last_pos = 0;
    unsigned n_bqt = 0, n_mm_bqt = 0, n_mm_left = 0, n_mm_right = 0,
             num_mm = 0, n_ind = 0;
    // column b's state: its hap position xs and ins; each chunk decodes
    // the next one's ahead (columns past the row hold 0: no column)
    int m = ms[lane];
    int xs = stat_xs(m, SP, RO, hl_p), ins = m >= SP;
    for (int c = 0; c < nch; ++c) {
      const int b = 32 * c + lane;
      const int mn = c + 1 < nch ? ms[b + 32] : 0;
      const int xsn = stat_xs(mn, SP, RO, hl_p), insn = mn >= SP;
      // column b + 1: the next lane's; lane 31's from the next chunk
      int key1 = __shfl_sync(kFull, 2 * xs + ins, (lane + 1) & 31);
      const int key1n = __shfl_sync(kFull, 2 * xsn + insn, 0);
      if (lane == 31) key1 = key1n;
      const int on = (unsigned)(xs - 1) < hlu && b < rl_p;
      const int noins_on = on && !ins, inhap = on && ins;
      const int del_ev =
          noins_on && !(key1 & 1) && b + 1 < rl_p && (key1 >> 1) - xs > 1;
      // the slot tests' hap position: -3 / -4 off the hap (sentinels),
      // a negative one wrapping from the hap's end
      const int hp = noins_on ? xs - 1 : (xs == 0 ? -3 : -4);
      const int wrap = hp >= 0 ? hp : hl_p + hp;
      const int hch = hc[min(max(wrap, 0), H_pad - 1)];
      const int mm = hch != rc[b];
      ms[b] = (hp + 4) << 2 | (hch == 'N') << 1 | mm;
      const unsigned mb = __ballot_sync(kFull, noins_on && bq[b] != 0);
      if (lane == 0) masks[c] = mb;
      n_bqt += __popc(mb);
      if (noins_on) {
        fbv = min(fbv, hp);
        lbv = max(lbv, hp);
      }
      // the mismatch counts from ballots, skipped by the (most) chunks
      // without a mismatch; columns b > rl - 6 are lanes t and up
      const unsigned M = __ballot_sync(kFull, noins_on && mm);
      if (M) {
        const int t = rl_p - 5 - 32 * c;
        n_mm_bqt += __popc(M & mb);
        num_mm += __popc(M & __ballot_sync(kFull, q95[b] != 0));
        n_mm_left += c ? 0 : __popc(M & 0x3fu);
        n_mm_right += __popc(M & (t <= 0 ? kFull : t < 32 ? kFull << t : 0));
        any_mm = 1;
      }
      // n_ind, skipped by chunks with no ins column and no deletion: an
      // ins-on column is an entry unless an earlier column of its run of
      // ins columns is ins-on (the run from the last non-ins column
      // before it, or from an earlier chunk: `seen`)
      if (__any_sync(kFull, ins || del_ev)) {
        const unsigned I = __ballot_sync(kFull, ins);
        const unsigned H = __ballot_sync(kFull, inhap);
        const unsigned z = ~I & below;
        const int prior = z ? ((H & below) >> (32 - __clz(z))) != 0
                            : (seen || (H & below) != 0);
        const int ev = (inhap && !prior) || del_ev;
        // new unless the last event before it (in this chunk, else the
        // carried one) has its position
        const unsigned E = __ballot_sync(kFull, ev);
        const unsigned e = E & below;
        const int pxs = __shfl_sync(kFull, xs, e ? 31 - __clz(e) : 0);
        const int fresh =
            ev && (e ? xs != pxs : (!has_prev || xs != last_pos));
        n_ind += __popc(__ballot_sync(kFull, fresh));
        seen = (I >> 31) &&
               (~I ? (H >> (32 - __clz(~I))) != 0 : (seen || H != 0));
        if (E) {
          last_pos = __shfl_sync(kFull, xs, 31 - __clz(E));
          has_prev = 1;
        }
      } else {
        seen = 0;  // the chunk ends on a column that is not ins
      }
      m = mn;
      xs = xsn;
      ins = insn;
    }
    fbv = __reduce_min_sync(kFull, fbv);
    lbv = __reduce_max_sync(kFull, lbv);
    int* ints = at<int>(lay.ints_at());
    uint8_t* flags = smem + lay.flags_at();
    if (lane == 0) {
      ints[p] = fbv == kBig ? -1 : fbv;
      ints[P + p] = lbv;
      ints[2 * P + p] = n_bqt;
      ints[3 * P + p] = n_mm_bqt;
      ints[4 * P + p] = n_mm_left;
      ints[5 * P + p] = n_mm_right;
      ints[6 * P + p] = num_mm;
      ints[7 * P + p] = n_ind;
      flags[p] = has_prev;  // has_event: some column was an event
      flags[P + p] = any_mm;
    }
    __syncwarp();  // the decoded row, for every lane
    slots(p, p0, ms, min(max(rl_p, 0), lay.L_pad), !off_p && !has_prev,
          max_mismatch);
  }

  // pair p's V slot tests over its decoded row's first ncol columns,
  // kSlotGroup slots a pass.  Per column one word w counts, in fields of
  // 11, 11 and 10 bits, a no-ins column, a mismatch and a mismatch
  // against an N; slot k adds w for each column with hap position in
  // [left, right] and ORs the sentinels' bits (RO 1, LO 2) into lr[k].
  // A lane's fields count at most nch columns; they are reduced apart
  // over the warp, then the coverage test; all false unless sel.
  __device__ __forceinline__ void slots(int p, int p0, const int* ms,
                                        int ncol, bool sel,
                                        int max_mismatch) {
    const int V = lay.V;
    const int* left = reinterpret_cast<const int*>(smem + lay.left_at());
    const int* right = reinterpret_cast<const int*>(smem + lay.right_at());
    const uint8_t* sflag = smem + lay.sflag_at();
    uint8_t* cov = smem + lay.cov_at();
    for (int v0 = 0; v0 < V; v0 += kSlotGroup) {
      const int g = min(kSlotGroup, V - v0);
      // slot k matches hap positions lo[k] .. lo[k] + span[k] (INT_MIN
      // and 0: none)
      int lo[kSlotGroup];
      unsigned span[kSlotGroup], acc[kSlotGroup], lr[kSlotGroup];
      int any = 0;
#pragma unroll
      for (int k = 0; k < kSlotGroup; ++k) {
        lo[k] = INT_MIN;
        span[k] = acc[k] = lr[k] = 0;
        if (k < g) {
          const int s = p0 * V + v0 + k;
          const int l = left[s], r = right[s];
          if (sel && (sflag[s] & 2) && r >= l) {
            lo[k] = l;
            span[k] = (unsigned)r - (unsigned)l;
            any = 1;
          }
        }
      }
      if (any) {
        for (int b = lane; b < ncol; b += 32) {
          const unsigned d = (unsigned)ms[b];
          const int hp = ((int)d >> 2) - 4;
          const unsigned w = (unsigned)(hp >= 0) | (d & 1) << 11 |
                             (unsigned)((d & 3) == 3) << 22;
          const unsigned sent = hp < 0 ? (unsigned)(hp + 5) : 0u;
#pragma unroll
          for (int k = 0; k < kSlotGroup; ++k) {
            if (k == g) break;
            if ((unsigned)hp - (unsigned)lo[k] <= span[k]) {
              acc[k] += w;
              lr[k] |= sent;
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kSlotGroup; ++k) {
        if (k == g) break;
        const int s = p0 * V + v0 + k;
        const int f = sflag[s];
        if (sel && (f & 2)) {  // warp-uniform
          const unsigned c_noins = __reduce_add_sync(kFull, acc[k] & 0x7ff);
          const unsigned mm = __reduce_add_sync(kFull, acc[k] >> 11 & 0x7ff);
          const unsigned mmn = __reduce_add_sync(kFull, acc[k] >> 22);
          const unsigned sk = __reduce_or_sync(kFull, lr[k]);
          const long long c_size =
              (long long)c_noins + (sk & 1) + (sk >> 1);
          const long long ln = (long long)right[s] - left[s] + 1;
          // a deletion's mismatches leave out those against an N
          const bool ok_mm = (int)(f & 1 ? mm - mmn : mm) <= max_mismatch;
          if (lane == 0)
            cov[p * V + v0 + k] =
                f & 1 ? (c_size >= ln && ok_mm) : (ok_mm && c_size == ln);
        } else if (lane == 0) {
          cov[p * V + v0 + k] = 0;
        }
      }
    }
  }

  // phase 3 (after a __syncthreads): thread p < np adds pair p's
  // m_log_bq terms in column order, skipping the masked ones (+0.0)
  __device__ __forceinline__ void sums() const {
    const int p = threadIdx.x;
    if (p >= np) return;
    const unsigned char* reg = region(p);
    const unsigned* masks =
        reinterpret_cast<const unsigned*>(reg + lay.mask_at());
    const double* lq = reinterpret_cast<const double*>(reg + lay.lq_at());
    double s = 0.0;
    for (int c = 0; c < lay.nch(); ++c) {
      const unsigned m = masks[c];
      const double* q = lq + 32 * c;
#pragma unroll
      for (int j0 = 0; j0 < 32; j0 += 8) {
        if (!((m >> j0) & 0xffu)) continue;
        double t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          t[j] = (m >> (j0 + j)) & 1 ? q[j0 + j] : 0.0;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if ((m >> (j0 + j)) & 1) s = s + t[j];
      }
    }
    reinterpret_cast<double*>(smem + lay.mlq_at())[p] = s;
  }

  // phase 4 (after a __syncthreads): the staged outputs, consecutive
  // threads on consecutive pairs
  __device__ __forceinline__ void write(int* __restrict__ ints,
                                        double* __restrict__ m_log_bq,
                                        uint8_t* __restrict__ flags,
                                        uint8_t* __restrict__ cov_ok,
                                        int B) const {
    const int t = threadIdx.x, P = lay.P;
    const int* is = reinterpret_cast<const int*>(smem + lay.ints_at());
    for (int e = t; e < 8 * np; e += kStatThreads) {
      const int k = e / np, q = e - k * np;
      ints[(size_t)k * B + i0 + q] = is[k * P + q];
    }
    const double* ml = reinterpret_cast<const double*>(smem + lay.mlq_at());
    const uint8_t* fs = smem + lay.flags_at();
    for (int q = t; q < np; q += kStatThreads) {
      m_log_bq[i0 + q] = ml[q];
      flags[i0 + q] = fs[q];
      flags[B + i0 + q] = fs[P + q];
    }
    const uint8_t* cs = smem + lay.cov_at();
    for (int e = t; e < np * lay.V; e += kStatThreads)
      cov_ok[(size_t)i0 * lay.V + e] = cs[e];
  }
};

// P pairs a block (pair_stats_shape).  ints is (8, B): fb, lb, n_bqt,
// n_mm_bqt, n_mm_left, n_mm_right, num_mm, n_ind; flags is (2, B):
// has_event, any_mism; cov_ok is (B, V).
__global__ void __launch_bounds__(kStatThreads)
pair_stats_kernel(const int* __restrict__ map_state,
                  const int* __restrict__ read_len,
                  const int* __restrict__ hap_len,
                  const int64_t* __restrict__ read_idx,
                  const int64_t* __restrict__ hap_idx,
                  const uint8_t* __restrict__ read_codes_r,
                  const uint8_t* __restrict__ hap_codes_h,
                  const uint8_t* __restrict__ bqt_r,
                  const uint8_t* __restrict__ q95_r,
                  const double* __restrict__ log10q_r,
                  const int* __restrict__ v_left_h,
                  const int* __restrict__ v_right_h,
                  const uint8_t* __restrict__ v_isdel_h,
                  const uint8_t* __restrict__ v_valid_h,
                  const uint8_t* __restrict__ off_hap_hmq,
                  int* __restrict__ ints, double* __restrict__ m_log_bq,
                  uint8_t* __restrict__ flags, uint8_t* __restrict__ cov_ok,
                  int B, int H_pad, int L_pad, int V, int max_mismatch,
                  int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  StatsBlock b(smem, StatsSmem{P, L_pad, H_pad, V}, B);
  b.stage(map_state, read_len, hap_len, read_idx, hap_idx, read_codes_r,
          hap_codes_h, bqt_r, q95_r, log10q_r, v_left_h, v_right_h, v_isdel_h,
          v_valid_h, off_hap_hmq);
  b.pairs(max_mismatch);
  __syncthreads();
  b.sums();
  __syncthreads();
  b.write(ints, m_log_bq, flags, cov_ok, B);
}

// window_call's shared memory, KT pairs a block, R reads a chunk: the t
// values (KT rows of R + 1, so that rows start in different banks), the
// (S+1) x KT accumulators and the KT pairs' haps.
struct WindowSmem {
  int KT, R, S;
  size_t elem;
  __host__ __device__ size_t acc_at() const {
    return (size_t)KT * (R + 1);
  }
  __host__ __device__ size_t ints_at() const {
    return (acc_at() + (size_t)(S + 1) * KT) * elem;
  }
  __host__ __device__ size_t total() const { return ints_at() + 8 * KT; }
};

// One block of window_call: window w and its pairs k0 .. k0 + nk - 1 (the
// k-th pair (h1 <= h2) in pair_enum order: h1 major).  Accumulator a =
// j * nk + kk is base[w, k0 + kk] for j = 0 and site[w, j - 1, k0 + kk]
// for j >= 1.  The phases are the kernel's; a thread takes elements t,
// t + kWinThreads, ... of each.
template <typename T>
struct WindowBlock {
  T *tv, *acc;
  int* hs;        // h1 of pair kk at kk, h2 at KT + kk
  const int* im;  // index_map rows of window w
  int w, k0, nk, nr, nacc, NH, NP, S, NR, R, KT;

  __device__ WindowBlock(unsigned char* smem, const WindowSmem& lay,
                         const int* __restrict__ index_map,
                         const int* __restrict__ nr_w, int NH_, int NR_)
      : tv(reinterpret_cast<T*>(smem)),
        acc(tv + lay.acc_at()),
        hs(reinterpret_cast<int*>(smem + lay.ints_at())),
        w(blockIdx.y),
        k0(blockIdx.x * lay.KT),
        NH(NH_),
        NP(NH_ * (NH_ + 1) / 2),
        S(lay.S),
        NR(NR_),
        R(lay.R),
        KT(lay.KT) {
    nk = min(KT, NP - k0);
    nacc = (S + 1) * nk;
    nr = min(max(nr_w[w], 0), NR);
    im = index_map + (size_t)w * NH * NR;
  }

  // the pairs' haps into hs (a __syncthreads must follow)
  __device__ __forceinline__ void pairs() {
    for (int kk = threadIdx.x; kk < nk; kk += kWinThreads) {
      int h1 = 0, rem = k0 + kk;
      while (rem >= NH - h1) {
        rem -= NH - h1;
        ++h1;
      }
      hs[kk] = h1;
      hs[KT + kk] = h1 + rem;
    }
  }

  // accumulator a's value before the first read
  __device__ __forceinline__ T seed(const T* __restrict__ pair_pr,
                                    int a) const {
    const int j = a / nk;
    return j == 0 ? T(0)
                  : pair_pr[((size_t)w * S + (j - 1)) * NP + k0 +
                            (a - j * nk)];
  }

  // stores the seeds: thread t's own (`mine`, loaded at the start so
  // that its latency overlaps the first chunk's), the rest loaded here
  __device__ __forceinline__ void put_seeds(const T* __restrict__ pair_pr,
                                            T mine) {
    const int t = threadIdx.x;
    if (t < nacc) acc[t] = mine;
    for (int a = t + kWinThreads; a < nacc; a += kWinThreads)
      acc[a] = seed(pair_pr, a);
  }

  // phase 1: tv[kk][r] = log(.5) + (m + log(1 + exp(mn - m))) of ll at
  // index_map[w, h1, r0 + r] and [w, h2, r0 + r] (NaN if either is), r
  // < rc.  Elements (kk, r) of the nk x rc, kGather a thread at a time:
  // their index loads, then their ll loads, then the t values; (kk, r)
  // steps without a division.
  __device__ __forceinline__ void terms(const T* __restrict__ ll, int r0,
                                        int rc, T log5) {
    const T one = T(1);
    const int dk = kWinThreads / rc, dr = kWinThreads - dk * rc;
    int kk = threadIdx.x / rc, r = threadIdx.x - kk * rc;
    while (kk < nk) {
      int ia[kGather], ib[kGather], at[kGather];
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        at[q] = -1;
        if (kk < nk) {
          const int* row = im + r0 + r;
          ia[q] = row[(size_t)hs[kk] * NR];
          ib[q] = row[(size_t)hs[KT + kk] * NR];
          at[q] = kk * (R + 1) + r;
        }
        kk += dk;
        r += dr;
        if (r >= rc) {
          r -= rc;
          ++kk;
        }
      }
      T la[kGather], lb[kGather];
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        if (at[q] >= 0) {
          la[q] = ll[ia[q]];
          lb[q] = ll[ib[q]];
        }
      }
#pragma unroll
      for (int q = 0; q < kGather; ++q) {
        if (at[q] < 0) continue;
        const T a = la[q], b = lb[q];
        T m, mn;
        if (is_nan(a) || is_nan(b)) {
          m = mn = T(NAN);
        } else {
          m = a > b ? a : b;
          mn = a < b ? a : b;
        }
        tv[at[q]] = log5 + (m + lg(one + ex(mn - m)));
      }
    }
  }

  // phase 2: each accumulator adds the chunk's rc values of its pair in
  // read order; the next eight values are loaded before the eight adds
  __device__ __forceinline__ void sums(int rc) {
    for (int a = threadIdx.x; a < nacc; a += kWinThreads) {
      const T* src = tv + (a % nk) * (R + 1);
      T s = acc[a];
      int r = 0;
      if (rc >= 8) {
        T q[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) q[j] = src[j];
        for (r = 8; r + 8 <= rc; r += 8) {
          T n[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) n[j] = src[r + j];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s = s + q[j];
            q[j] = n[j];
          }
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) s = s + q[j];
      }
      for (; r < rc; ++r) s = s + src[r];
      acc[a] = s;
    }
  }

  // base and site; the reads past nr_w add +0.0 in the plain version,
  // which one +0.0 stands for
  __device__ __forceinline__ void write(T* __restrict__ base,
                                        T* __restrict__ site) const {
    for (int a = threadIdx.x; a < nacc; a += kWinThreads) {
      const int j = a / nk, k = k0 + (a - j * nk);
      T s = acc[a];
      if (nr < NR) s = s + T(0);
      if (j == 0)
        base[(size_t)w * NP + k] = s;
      else
        site[((size_t)w * S + (j - 1)) * NP + k] = s;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kWinThreads, kWinBlocksPerSM)
window_call_kernel(const T* __restrict__ ll,
                   const int* __restrict__ index_map,
                   const int* __restrict__ nr_w, const T* __restrict__ pair_pr,
                   T* __restrict__ base, T* __restrict__ site, int NH,
                   int S, int NR, int KT, int R, T log5) {
  extern __shared__ __align__(16) unsigned char smem[];
  WindowBlock<T> b(smem, WindowSmem{KT, R, S, sizeof(T)}, index_map, nr_w,
                   NH, NR);
  const int t = threadIdx.x;
  const T mine = t < b.nacc ? b.seed(pair_pr, t) : T(0);
  b.pairs();
  __syncthreads();
  for (int r0 = 0; r0 < b.nr; r0 += R) {
    const int rc = min(R, b.nr - r0);
    b.terms(ll, r0, rc, log5);
    if (r0 == 0) b.put_seeds(pair_pr, mine);
    __syncthreads();
    b.sums(rc);
    __syncthreads();
  }
  if (b.nr == 0) {
    b.put_seeds(pair_pr, mine);
    __syncthreads();
  }
  b.write(base, site);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess || n <= 0)
    n = 132;
  return n;
}

// the largest power of two <= n (1 for n < 2)
int pow2_floor(long long n) {
  int p = 1;
  while ((long long)p * 2 <= n) p *= 2;
  return p;
}

// finish's launch for B pairs: P pairs a block, the power of two at or
// below B over four times the SMs (a grid of four to eight blocks an SM),
// kept in [kFinWarps, kFinMaxPairs], halved while the block's shared
// memory would not fit (P 0: nothing fits)
FinishSmem finish_shape(int B, int L_pad, size_t elem) {
  int P = pow2_floor(B / (4LL * sm_count()));
  P = min(max(P, kFinWarps), kFinMaxPairs);
  FinishSmem lay{P, L_pad | 1, elem};
  while (lay.total() > (size_t)kMaxSmem && lay.P > 1) lay.P /= 2;
  if (lay.total() > (size_t)kMaxSmem) lay.P = 0;
  return lay;
}

// pair_stats's launch for B pairs: P pairs a block, the power of two at
// or below B over eight times the SMs (a pair's rows take ~2 kB of
// shared memory at the main path's shapes, so a block of P pairs
// leaves room for several blocks an SM), kept in [kStatWarps,
// kStatMaxPairs], halved while the block's shared memory would not fit
// (P 0: nothing fits)
StatsSmem pair_stats_shape(int B, int H_pad, int L_pad, int V) {
  int P = pow2_floor(B / (8LL * sm_count()));
  P = min(max(P, kStatWarps), kStatMaxPairs);
  StatsSmem lay{P, L_pad, H_pad, V};
  while (lay.total() > (size_t)kMaxSmem && lay.P > 1) lay.P /= 2;
  if (lay.total() > (size_t)kMaxSmem) lay.P = 0;
  return lay;
}

// window_call's launch: KT pairs a block, the W x NP pairs over the
// card's resident blocks (one wave), at most as many as leave each
// thread one accumulator; R reads a chunk, kWinTile t values over KT, at
// least 32
WindowSmem window_shape(int W, int NP, int S, int NR, size_t elem) {
  const long long per_sm = (long long)kWinBlocksPerSM * sm_count();
  int KT = (int)(((long long)W * NP + per_sm - 1) / per_sm);
  KT = max(1, min(KT, min(NP, max(1, kWinThreads / (S + 1)))));
  return WindowSmem{KT, max(32, min(kWinTile / KT, max(NR, 1))), S, elem};
}

// lets `kernel` take `bytes` of dynamic shared memory
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= (size_t)kStaticSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

#if DINDEL_EPI_DOUBLE
typedef double epi_real;
#define DINDEL_EPI_TYPE f64
#else
typedef float epi_real;
#define DINDEL_EPI_TYPE f32
#endif
#if DINDEL_EPI_EXACT
#define DINDEL_EPI_FOLD exact
#else
#define DINDEL_EPI_FOLD fast
#endif
#define DINDEL_EPI_CAT3(a, t, f) a##t##_##f
#define DINDEL_EPI_NAME3(a, t, f) DINDEL_EPI_CAT3(a, t, f)
#define DINDEL_EPI_CAT2(a, t) a##t
#define DINDEL_EPI_NAME2(a, t) DINDEL_EPI_CAT2(a, t)

// dindel_finish_{f32,f64}_{fast,exact}: 0 on a launched kernel, else the
// CUDA error code.  (B, 2(H_pad+2)) rows in; fl is (3, B): ll, ll_off,
// ll_on; fb is (2, B): off_hap, off_hap_hmq; map_state (B, L_pad) int32.
// read_len may be null (see finish_kernel).  Pairs a block: finish_shape.
extern "C" int DINDEL_EPI_NAME3(dindel_finish_, DINDEL_EPI_TYPE,
                                DINDEL_EPI_FOLD)(
    const int* b_mid, const int* hap_len, const int* read_len,
    const epi_real* alpha, const epi_real* beta, const epi_real* obs,
    const epi_real* prior_rmq, const epi_real* prior_hmq, const uint8_t* btf,
    const uint8_t* btb, epi_real* fl, uint8_t* fb, int* map_state, int B,
    int H_pad, int L_pad, int numT, void* stream) {
  if (B <= 0 || H_pad < 0 || L_pad < 1 || numT < 2 || numT > 15)
    return (int)cudaErrorInvalidValue;
  const FinishSmem lay = finish_shape(B, L_pad, sizeof(epi_real));
  if (lay.P == 0) return (int)cudaErrorInvalidValue;
  auto kernel = finish_kernel<epi_real, DINDEL_EPI_EXACT != 0>;
  cudaError_t err = allow_smem(kernel, lay.total());
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((B + lay.P - 1) / lay.P), kFinThreads, lay.total(),
           static_cast<cudaStream_t>(stream)>>>(
      b_mid, hap_len, read_len, alpha, beta, obs, prior_rmq, prior_hmq, btf,
      btb, fl, fb, map_state, B, H_pad, L_pad, numT, lay.P);
  return (int)cudaGetLastError();
}

#if !DINDEL_EPI_EXACT
// dindel_window_call_{f32,f64}: 0 on a launched kernel, else the CUDA
// error code.  ll (flat, the fold's type), index_map (W, NH, NR) int32,
// nr_w (W,) int32, pair_pr (W, S, NP); base (W, NP), site (W, S, NP).
// Pairs a block and reads a chunk: window_shape.
extern "C" int DINDEL_EPI_NAME2(dindel_window_call_, DINDEL_EPI_TYPE)(
    const epi_real* ll, const int* index_map, const int* nr_w,
    const epi_real* pair_pr, epi_real* base, epi_real* site, int W, int NH,
    int S, int NR, double log5, void* stream) {
  const int NP = NH * (NH + 1) / 2;
  if (W <= 0 || W > 65535 || NH <= 0 || S < 0 || NR < 0)
    return (int)cudaErrorInvalidValue;
  const WindowSmem lay = window_shape(W, NP, S, NR, sizeof(epi_real));
  if (lay.total() > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = window_call_kernel<epi_real>;
  cudaError_t err = allow_smem(kernel, lay.total());
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((NP + lay.KT - 1) / lay.KT), (unsigned)W);
  kernel<<<grid, kWinThreads, lay.total(),
           static_cast<cudaStream_t>(stream)>>>(
      ll, index_map, nr_w, pair_pr, base, site, NH, S, NR, lay.KT, lay.R,
      (epi_real)log5);
  return (int)cudaGetLastError();
}
#endif

#if !DINDEL_EPI_EXACT && !DINDEL_EPI_DOUBLE
// dindel_pair_stats: 0 on a launched kernel, else the CUDA error code.
// Shapes as pair_stats_kernel's comment; the per-read tables are
// (rows, L_pad), the hap codes (rows, H_pad), the slot tables (rows, V).
// Pairs a block: pair_stats_shape.
extern "C" int dindel_pair_stats(
    const int* map_state, const int* read_len, const int* hap_len,
    const int64_t* read_idx, const int64_t* hap_idx,
    const uint8_t* read_codes_r, const uint8_t* hap_codes_h,
    const uint8_t* bqt_r, const uint8_t* q95_r, const double* log10q_r,
    const int* v_left_h, const int* v_right_h, const uint8_t* v_isdel_h,
    const uint8_t* v_valid_h, const uint8_t* off_hap_hmq, int* ints,
    double* m_log_bq, uint8_t* flags, uint8_t* cov_ok, int B, int H_pad,
    int L_pad, int V, int max_mismatch, void* stream) {
  // the slot tests count at most 1023 chunks a lane in 10-bit fields,
  // the column pass packs 2 xs + ins in an int
  if (B <= 0 || H_pad < 1 || H_pad > kStatMaxHPad || L_pad < 1 ||
      L_pad > kStatMaxLPad || V < 0)
    return (int)cudaErrorInvalidValue;
  const StatsSmem lay = pair_stats_shape(B, H_pad, L_pad, V);
  if (lay.P == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(pair_stats_kernel, lay.total());
  if (err != cudaSuccess) return (int)err;
  pair_stats_kernel<<<(unsigned)((B + lay.P - 1) / lay.P), kStatThreads,
                      lay.total(), static_cast<cudaStream_t>(stream)>>>(
      map_state, read_len, hap_len, read_idx, hap_idx, read_codes_r,
      hap_codes_h, bqt_r, q95_r, log10q_r, v_left_h, v_right_h, v_isdel_h,
      v_valid_h, off_hap_hmq, ints, m_log_bq, flags, cov_ok, B, H_pad, L_pad,
      V, max_mismatch, lay.P);
  return (int)cudaGetLastError();
}

__global__ void noop_kernel() {}

// dindel_finish_shape: finish's launch for B pairs of L_pad columns in a
// type of `elem` bytes: out = (pairs a block, blocks, dynamic shared
// memory bytes); dindel_pair_stats_shape: pair_stats's for B pairs,
// out = (pairs a block, blocks, dynamic shared memory bytes);
// dindel_window_call_shape: window_call's, out = (pairs a block, reads
// a chunk, blocks, dynamic shared memory bytes).  For the launch logs;
// the entry points above launch with these shapes.  All return 0.
extern "C" int dindel_finish_shape(int B, int L_pad, int elem, int* out) {
  const FinishSmem lay = finish_shape(B, L_pad, (size_t)elem);
  out[0] = lay.P;
  out[1] = lay.P ? (B + lay.P - 1) / lay.P : 0;
  out[2] = (int)lay.total();
  return 0;
}

extern "C" int dindel_pair_stats_shape(int B, int H_pad, int L_pad, int V,
                                       int* out) {
  const StatsSmem lay = pair_stats_shape(B, H_pad, L_pad, V);
  out[0] = lay.P;
  out[1] = lay.P ? (B + lay.P - 1) / lay.P : 0;
  out[2] = (int)lay.total();
  return 0;
}

extern "C" int dindel_window_call_shape(int W, int NH, int S, int NR,
                                        int elem, int* out) {
  const int NP = NH * (NH + 1) / 2;
  const WindowSmem lay = window_shape(W, NP, S, NR, (size_t)elem);
  out[0] = lay.KT;
  out[1] = lay.R;
  out[2] = (NP + lay.KT - 1) / lay.KT * W;
  out[3] = (int)lay.total();
  return 0;
}

// dindel_epilogue_noop: one empty block of one warp, launched as the
// kernels above are (the launch floor no launch beats); 0 or the CUDA
// error code.
extern "C" int dindel_epilogue_noop(void* stream) {
  noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
#endif
