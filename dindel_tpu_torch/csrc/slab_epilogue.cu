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
// What bounds them on this card: memory latency.  Each is a sequential
// walk per pair (per output element for window_call) whose steps depend
// on the previous one (the backtrack's next state indexes the next
// backpointer row) or whose sum order is part of the result; the bytes
// they must move (finish reads five (B, 2(H_pad+2)) rows, the rest
// less) take tens of microseconds at the memory rate.
//
// What the design does about it: nothing yet, beyond being one launch
// each where PyTorch eager enqueued thousands of small ops from the host
// (the cost this port set out to remove).  One thread per pair for
// finish and pair_stats, one per output element for window_call, 128
// threads a block; every loop runs in the plain version's order.
//
// Numerics (the contract of the plain versions):
// - finish: base = (alpha + obs) + beta, vr = base + prior_rmq,
//   vh = base + prior_hmq, in the tensors' type and that association;
//   the exact fold takes `v > ll + EPS` (EPS in the tensors' type), the
//   fast fold a strict `>` from x = 0 (first-occurrence argmax; NaN wins
//   as in torch.argmax/amax).  The walks decode the 4-bit class codes as
//   finish.py does, with a floor modulo (PyTorch's `%` on the state), so
//   a garbage code never indexes outside its row.
// - pair_stats: integer counts, and m_log_bq summed in column order in
//   float64 with masked terms added as +0.0.
// - window_call: t = log(.5) + (m + log(1 + exp(mn - m))) with expf/logf
//   (exp/log in double), added in read order, +0.0 for reads past nr_w.
//   Build with -fmad=false and without --use_fast_math.
//
// Built once per (type, fold) translation unit: DINDEL_EPI_DOUBLE and
// DINDEL_EPI_EXACT select them.  Each exports its finish entry point;
// the fast-fold units export window_call for their type, and the float32
// fast unit exports pair_stats (which has no type or fold).

#include <cuda_runtime.h>
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
constexpr int kThreads = 128;
constexpr int kBig = 2147483647;  // fb's empty-min sentinel (stats.py)

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ float ex(float v) { return expf(v); }
__device__ __forceinline__ double ex(double v) { return exp(v); }
__device__ __forceinline__ float lg(float v) { return logf(v); }
__device__ __forceinline__ double lg(double v) { return log(v); }

// the code of state `cur` in a backpointer row (noins | ins << 4)
__device__ __forceinline__ int code_at(const uint8_t* row, int cur, int SP,
                                       int* x) {
  *x = floor_mod(cur, SP);
  const int pack = row[*x];
  return (cur >= SP ? pack >> 4 : pack) & 15;
}

// the state before `cur` on the forward (Dec) pass's path
__device__ __forceinline__ int decode_fwd(const uint8_t* row, int cur,
                                          int SP, int RO, int hl) {
  int x;
  const int c = code_at(row, cur, SP, &x);
  if (cur >= SP) return c == 0 ? cur : x;
  if (x == RO) return c == 0 ? SP + RO : c == 1 ? SP + hl : c == 2 ? RO : hl;
  return c == 0 ? SP + max(x - 1, 0) : c == 1 ? x : max(x - (c - 1), 0);
}

// the state after `cur` on the backward (Inc) pass's path
__device__ __forceinline__ int decode_bwd(const uint8_t* row, int cur,
                                          int SP, int RO, int hl, int numT) {
  int x;
  const int c = code_at(row, cur, SP, &x);
  if (cur >= SP) {
    const int x1 = x + 1 <= hl ? x + 1 : RO;
    return c == 0 ? cur : c == 1 ? x : x1;
  }
  const int xy = x + (numT - c);
  return c == 0 ? SP + x : c == numT ? x : (xy <= hl ? xy : RO);
}

template <typename T>
__device__ __forceinline__ bool is_nan(T v) {
  return v != v;
}

// one thread per pair: the folds over the 2(H_pad+2) states at b_mid,
// then the walk down btf and up btb into map_state.  read_len may be
// null: the up walk then runs to L_pad-2 as the plain version does; else
// it stops at the pair's last read column and the columns past it hold
// the last state (the plain version decodes unwritten rows there).
template <typename T, bool EXACT>
__global__ void __launch_bounds__(kThreads)
finish_kernel(const int* __restrict__ b_mid, const int* __restrict__ hap_len,
              const int* __restrict__ read_len, const T* __restrict__ alpha,
              const T* __restrict__ beta, const T* __restrict__ obs,
              const T* __restrict__ prior_rmq,
              const T* __restrict__ prior_hmq,
              const uint8_t* __restrict__ btf,
              const uint8_t* __restrict__ btb, T* __restrict__ fl,
              uint8_t* __restrict__ fb, int* __restrict__ map_state, int B,
              int H_pad, int L_pad, int numT) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int SP = H_pad + 2, S = 2 * SP, RO = H_pad + 1;
  const T neginf = T(-INFINITY);
  const T eps = T(kEPS);
  const size_t row = (size_t)i * S;
  T ll = neginf, llH = neginf, off = neginf, on = neginf;
  int map_rmq = 0, s_mid = 0;
  for (int x = 0; x < S; ++x) {
    const T base = (alpha[row + x] + obs[row + x]) + beta[row + x];
    const T v = base + prior_rmq[row + x];
    const T w = base + prior_hmq[row + x];
    const int xm = x % SP;
    if (EXACT) {
      if (v > ll + eps) { ll = v; map_rmq = x; }
      if (w > llH + eps) { llH = w; s_mid = x; }
      if (xm == 0) { if (v > off) off = v; }
      else if (xm != RO) { if (v > on) on = v; }
    } else {
      if (v > ll || (is_nan(v) && !is_nan(ll))) { ll = v; map_rmq = x; }
      if (w > llH || (is_nan(w) && !is_nan(llH))) { llH = w; s_mid = x; }
      if (xm == 0) { if (v > off || is_nan(v)) off = v; }
      else if (xm != RO) { if (v > on || is_nan(v)) on = v; }
    }
  }
  fl[i] = ll;
  fl[B + i] = off;
  fl[2 * B + i] = on;
  const int xr = map_rmq % SP, xh = s_mid % SP;
  fb[i] = (xr == 0) | (xr == RO);
  fb[B + i] = (xh == 0) | (xh == RO);

  const int hl = hap_len[i];
  const int rl = read_len ? read_len[i] : L_pad;
  // the anchor column: map_state is the down walk left of it, the up
  // walk right of it
  const int a = min(max(b_mid[i], 0), L_pad - 1);
  int* ms = map_state + (size_t)i * L_pad;
  const size_t rstride = (size_t)B * SP;
  const uint8_t* rowf = btf + (size_t)i * SP;
  const uint8_t* rowb = btb + (size_t)i * SP;
  ms[a] = s_mid;
  int cur = s_mid;
  for (int b = a; b >= 1; --b) {  // column b-1 from btf row b-1
    cur = decode_fwd(rowf + (size_t)(b - 1) * rstride, cur, SP, RO, hl);
    ms[b - 1] = cur;
  }
  cur = s_mid;
  const int last = min(L_pad - 2, rl - 2);
  int b = a;
  for (; b <= last; ++b) {  // column b+1 from btb row b
    cur = decode_bwd(rowb + (size_t)b * rstride, cur, SP, RO, hl, numT);
    ms[b + 1] = cur;
  }
  for (; b <= L_pad - 2; ++b) ms[b + 1] = cur;
}

// one thread per pair: one pass over the read columns carrying every
// count, then the coverage test per variant slot.  ints is (8, B): fb,
// lb, n_bqt, n_mm_bqt, n_mm_left, n_mm_right, num_mm, n_ind; flags is
// (2, B): has_event, any_mism; cov_ok is (B, V).
__global__ void __launch_bounds__(kThreads)
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
                  int B, int H_pad, int L_pad, int V, int max_mismatch) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= B) return;
  const int SP = H_pad + 2, RO = H_pad + 1;
  const int hl = hap_len[i], rl = read_len[i];
  const int64_t ri = read_idx[i], hi = hap_idx[i];
  const int* ms = map_state + (size_t)i * L_pad;
  const uint8_t* rc = read_codes_r + ri * L_pad;
  const uint8_t* bq = bqt_r + ri * L_pad;
  const uint8_t* q95 = q95_r + ri * L_pad;
  const double* lq = log10q_r + ri * L_pad;
  const uint8_t* hc = hap_codes_h + hi * H_pad;

  // column b's (ins, xs, on): xs is the hap position, RO read as hl + 1
  auto column = [&](int b, bool* ins, int* xs, bool* on) {
    const int m = ms[b];
    const int xa = floor_mod(m, SP);
    *ins = m >= SP;
    *xs = xa == RO ? hl + 1 : xa;
    *on = *xs >= 1 && *xs <= hl && b < rl;
  };

  int fbv = kBig, lbv = -1, n_bqt = 0, n_mm_bqt = 0, n_mm_left = 0,
      n_mm_right = 0, num_mm = 0, n_ind = 0, last_pos = 0;
  bool has_event = false, any_mism = false, has_prev = false,
       seen_run = false;
  double mlq = 0.0;
  bool ins0, on0;
  int xs0;
  column(0, &ins0, &xs0, &on0);
  for (int b = 0; b < L_pad; ++b) {
    bool ins1 = false, on1 = false;
    int xs1 = 0;
    if (b + 1 < L_pad) column(b + 1, &ins1, &xs1, &on1);
    const bool noins_on = on0 && !ins0;
    const bool del_ev =
        noins_on && !ins1 && b + 1 < rl && b + 1 < L_pad && xs1 - xs0 > 1;
    const bool inhap = ins0 && on0;
    has_event |= inhap || del_ev;
    bool bqt = false;
    if (noins_on) {
      fbv = min(fbv, xs0 - 1);
      lbv = max(lbv, xs0 - 1);
      bqt = bq[b] != 0;
      const bool mism = rc[b] != hc[min(max(xs0 - 1, 0), H_pad - 1)];
      n_bqt += bqt;
      n_mm_bqt += mism && bqt;
      n_mm_left += mism && b < 6;
      n_mm_right += mism && b > rl - 6;
      num_mm += mism && q95[b] != 0;
      any_mism |= mism;
    }
    mlq = mlq + (bqt ? lq[b] : 0.0);
    // distinct MAP-path indel-event positions
    const bool entry = inhap && !seen_run;
    seen_run = ins0 && (seen_run || inhap);
    const bool ev = entry || del_ev;
    n_ind += ev && (!has_prev || xs0 != last_pos);
    if (ev) last_pos = xs0;
    has_prev |= ev;
    ins0 = ins1;
    xs0 = xs1;
    on0 = on1;
  }
  ints[i] = fbv == kBig ? -1 : fbv;
  ints[B + i] = lbv;
  ints[2 * B + i] = n_bqt;
  ints[3 * B + i] = n_mm_bqt;
  ints[4 * B + i] = n_mm_left;
  ints[5 * B + i] = n_mm_right;
  ints[6 * B + i] = num_mm;
  ints[7 * B + i] = n_ind;
  m_log_bq[i] = mlq;
  flags[i] = has_event;
  flags[B + i] = any_mism;

  // filter coverage per variant slot (stats.py: the sentinel codes -3/-4
  // and the negative-index wrap from the hap end included)
  const bool sel = !off_hap_hmq[i] && !has_event;
  const int ncol = min(rl, L_pad);
  for (int v = 0; v < V; ++v) {
    const int64_t slot = hi * V + v;
    bool ok = false;
    if (sel && v_valid_h[slot]) {
      const int left = v_left_h[slot], right = v_right_h[slot];
      const bool isdel = v_isdel_h[slot] != 0;
      int c_noins = 0, nmm = 0;
      bool has_lo = false, has_ro = false;
      for (int b = 0; b < ncol; ++b) {
        bool ins, on;
        int xs;
        column(b, &ins, &xs, &on);
        const bool noins_on = on && !ins;
        const int hp = noins_on ? xs - 1 : (xs == 0 ? -3 : -4);
        if (hp < left || hp > right) continue;
        const int wrap = hp >= 0 ? hp : hl + hp;
        const uint8_t hchar = hc[min(max(wrap, 0), H_pad - 1)];
        c_noins += noins_on;
        has_lo |= hp == -3;
        has_ro |= hp == -4;
        nmm += hchar != rc[b] && (!isdel || hchar != 'N');
      }
      const long long c_size = (long long)c_noins + has_lo + has_ro;
      const long long ln = (long long)right - left + 1;
      const bool ok_mm = nmm <= max_mismatch;
      ok = isdel ? (c_size >= ln && ok_mm) : (ok_mm && c_size == ln);
    }
    cov_ok[(size_t)i * V + v] = ok;
  }
}

// one thread per output element (w, j, k): j = 0 is base[w, k], j = 1..S
// is site[w, j-1, k]; k is the k-th pair (h1 <= h2) in pair_enum order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
window_call_kernel(const T* __restrict__ ll,
                   const int* __restrict__ index_map,
                   const int* __restrict__ nr_w, const T* __restrict__ pair_pr,
                   T* __restrict__ base, T* __restrict__ site, int W, int NH,
                   int S, int NR, int NP, T log5) {
  const long long n = (long long)W * (S + 1) * NP;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int k = (int)(idx % NP);
  const int j = (int)((idx / NP) % (S + 1));
  const int w = (int)(idx / ((long long)NP * (S + 1)));
  int h1 = 0, rem = k;
  while (rem >= NH - h1) {
    rem -= NH - h1;
    ++h1;
  }
  const int h2 = h1 + rem;
  const int* im1 = index_map + ((size_t)w * NH + h1) * NR;
  const int* im2 = index_map + ((size_t)w * NH + h2) * NR;
  const int nr = nr_w[w];
  const T one = T(1), zero = T(0);
  T acc = j == 0 ? zero : pair_pr[((size_t)w * S + (j - 1)) * NP + k];
  for (int r = 0; r < NR; ++r) {
    T t = zero;
    if (r < nr) {
      const T a = ll[im1[r]], b = ll[im2[r]];
      T m, mn;
      if (is_nan(a) || is_nan(b)) {
        m = mn = T(NAN);
      } else {
        m = a > b ? a : b;
        mn = a < b ? a : b;
      }
      t = log5 + (m + lg(one + ex(mn - m)));
    }
    acc = acc + t;
  }
  if (j == 0)
    base[(size_t)w * NP + k] = acc;
  else
    site[((size_t)w * S + (j - 1)) * NP + k] = acc;
}

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
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
// read_len may be null (see finish_kernel).
extern "C" int DINDEL_EPI_NAME3(dindel_finish_, DINDEL_EPI_TYPE,
                                DINDEL_EPI_FOLD)(
    const int* b_mid, const int* hap_len, const int* read_len,
    const epi_real* alpha, const epi_real* beta, const epi_real* obs,
    const epi_real* prior_rmq, const epi_real* prior_hmq, const uint8_t* btf,
    const uint8_t* btb, epi_real* fl, uint8_t* fb, int* map_state, int B,
    int H_pad, int L_pad, int numT, void* stream) {
  if (B <= 0 || H_pad < 0 || L_pad < 1 || numT < 2 || numT > 15)
    return (int)cudaErrorInvalidValue;
  finish_kernel<epi_real, DINDEL_EPI_EXACT != 0>
      <<<blocks_for(B), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          b_mid, hap_len, read_len, alpha, beta, obs, prior_rmq, prior_hmq,
          btf, btb, fl, fb, map_state, B, H_pad, L_pad, numT);
  return (int)cudaGetLastError();
}

#if !DINDEL_EPI_EXACT
// dindel_window_call_{f32,f64}: 0 on a launched kernel, else the CUDA
// error code.  ll (flat, the fold's type), index_map (W, NH, NR) int32,
// nr_w (W,) int32, pair_pr (W, S, NP); base (W, NP), site (W, S, NP).
extern "C" int DINDEL_EPI_NAME2(dindel_window_call_, DINDEL_EPI_TYPE)(
    const epi_real* ll, const int* index_map, const int* nr_w,
    const epi_real* pair_pr, epi_real* base, epi_real* site, int W, int NH,
    int S, int NR, double log5, void* stream) {
  const int NP = NH * (NH + 1) / 2;
  if (W <= 0 || NH <= 0 || S < 0 || NR < 0)
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)W * (S + 1) * NP;
  window_call_kernel<epi_real>
      <<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          ll, index_map, nr_w, pair_pr, base, site, W, NH, S, NR, NP,
          (epi_real)log5);
  return (int)cudaGetLastError();
}
#endif

#if !DINDEL_EPI_EXACT && !DINDEL_EPI_DOUBLE
// dindel_pair_stats: 0 on a launched kernel, else the CUDA error code.
// Shapes as pair_stats_kernel's comment; the per-read tables are
// (rows, L_pad), the hap codes (rows, H_pad), the slot tables (rows, V).
extern "C" int dindel_pair_stats(
    const int* map_state, const int* read_len, const int* hap_len,
    const int64_t* read_idx, const int64_t* hap_idx,
    const uint8_t* read_codes_r, const uint8_t* hap_codes_h,
    const uint8_t* bqt_r, const uint8_t* q95_r, const double* log10q_r,
    const int* v_left_h, const int* v_right_h, const uint8_t* v_isdel_h,
    const uint8_t* v_valid_h, const uint8_t* off_hap_hmq, int* ints,
    double* m_log_bq, uint8_t* flags, uint8_t* cov_ok, int B, int H_pad,
    int L_pad, int V, int max_mismatch, void* stream) {
  if (B <= 0 || H_pad < 1 || L_pad < 1 || V < 0)
    return (int)cudaErrorInvalidValue;
  pair_stats_kernel<<<blocks_for(B), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      map_state, read_len, hap_len, read_idx, hap_idx, read_codes_r,
      hap_codes_h, bqt_r, q95_r, log10q_r, v_left_h, v_right_h, v_isdel_h,
      v_valid_h, off_hap_hmq, ints, m_log_bq, flags, cov_ok, B, H_pad, L_pad,
      V, max_mismatch);
  return (int)cudaGetLastError();
}
#endif
