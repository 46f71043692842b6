// Pair-HMM max-product DP (ObservationModelFBMaxErr), one warp per
// (haplotype, read) pair, for NVIDIA Hopper (sm_90a).
//
// Replaces: dindel_tpu/hmm/pallas_kernel.py `_make_kernel` (launched by
// `_build_call`, wrapped by `dp_pallas`), the TPU kernel of the JAX
// package.  Bound to PyTorch by ctypes through the plain C entry points
// at the end (dindel_tpu_torch/hmm/dp_kernel.py); the plain PyTorch
// version it is held to bit for bit is dindel_tpu_torch/hmm/dp_ref.py.
//
// What bounds it on this card: instruction issue, and within it the
// compare/select instructions.  Each pair is a serial recursion over its
// read bases (forward b = 1..MB, backward L_act-1..MN+1); a step updates
// S_half = H_pad+2 states, each a fold of numT+1 candidates (two adds on
// the FMA pipe, then a compare and two selects on the integer/logic
// pipe, which has half the lanes).  The backpointer planes, one byte per
// state-step, are the only large traffic and take an eighth of the time
// at the memory rate.
//
// What the design does about it:
// - one warp per pair, kWarps pairs per block: pairs are independent, so
//   neither step loop has a block barrier;
// - the DP row lives in registers: lane l owns the R contiguous states
//   x = l*R .. l*R+R-1 (R a template parameter, 32*R >= S_half), noins
//   and ins for each;
// - the stencil of reach numT-1 reads the neighbouring lanes' registers
//   by __shfl_up_sync (forward, sources x-y) and __shfl_down_sync
//   (backward, sources x+y, clamped to RO before the shuffle);
// - the three broadcast states: lane 0 (__shfl_sync), the hap end hl
//   (__shfl_sync from its owning lane) and RO, which every lane carries
//   as a redundant scalar (its recursion reads only broadcast values);
// - lane constants (lpe, lpn, lpe[x+1], the hap base) sit in registers
//   from before the step loops; the per-candidate costs lpe[x]+ky[y]
//   (forward) and the clamped slpn/slpe[x+y] sums (backward) are hoisted
//   too where they fit (R * (NTM-1) values), else formed per step
//   (forward) or read from a clamped per-warp shared-memory row
//   (backward);
// - the main path's numT (7, the default --maxLengthIndel 5) is a
//   template constant for S_half <= 256, so its candidate loops carry no
//   guards; other numT take the generic kernels (numT <= 15);
// - the read's per-step terms (eq, uq, base) are per-warp shared memory,
//   one broadcast load each per step;
// - backpointers are uint8 (noins | ins << 4).  The folds keep each ins
//   rank pre-shifted into its byte, so a lane's codes pack into 2-byte
//   words with integer adds, one logic op per word fills the dead states,
//   and the words are stored straight from the registers (rows are
//   S_half bytes, only 2-byte aligned; the L2 merges a step's words into
//   full sectors); lane 0 then rewrites the RO byte, after __syncwarp;
// - states past the hap end are never a live state's source (forward
//   sources are x-y < x, backward ones are clamped), so they are not
//   masked in the recursion, only in what is written; the one exception,
//   x=0's raw Wn[1] when hl = 0, is masked.
//
// Numerics (the contract of the plain version): candidates fold in the
// Pallas kernel's order and rank codes (exact EPS/TIE band rule, or the
// fast ascending-rank `>=` fold).  In float, W + logpLOgLO +
// logpNoInsgNoIns and W + logpFirstgLO + logpNoInsgNoIns add one
// constant summed in double and rounded once (the Pallas kernel's baked
// constants); in double they associate left to right, as the reference
// C++ does.  WiRO + logpLOgLO + lpeRO is left to right in both.  Build
// with -fmad=false: a contracted multiply-add rounds once where the
// reference rounds twice.
//
// Built once per (type, fold) translation unit: DINDEL_DP_DOUBLE and
// DINDEL_DP_EXACT select them, each exporting one entry point.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef DINDEL_DP_DOUBLE
#define DINDEL_DP_DOUBLE 0
#endif
#ifndef DINDEL_DP_EXACT
#define DINDEL_DP_EXACT 0
#endif

namespace {

constexpr double kEPS = 1e-10;    // ObservationModelFB.hpp:25
constexpr double kTIE = 1e-5;     // ObservationModelFB.cpp:883
constexpr double kNEGBIG = -1.0e30;
constexpr int kN = 'N';
constexpr int kMaxNumT = 15;      // 4-bit class codes
constexpr int kWarps = 4;         // pairs (warps) per block
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct Consts {
  T eps, tie, negbig;
  T lolo, first, lpig, nig, nn;   // the five model scalars
  T lolo_nn, first_nn;            // summed in double, rounded once
  T ky[kMaxNumT + 1];             // (y-1)*logpInsgIns, y >= 2
};

template <typename T, bool EXACT>
struct Fold;

// updateMax on (value, class rank); ranks descend with the source index,
// so the reference's tie-to-lower-index rule is cand_c > dest_c.
template <typename T>
struct Fold<T, true> {
  static __device__ __forceinline__ void apply(const Consts<T>& k, T& dv,
                                               int& dc, T cv, int cc) {
    bool take = (cv > dv + k.eps) ||
                ((cv >= dv) && (cv <= dv + k.tie) && (cc > dc));
    if (take) { dv = cv; dc = cc; }
  }
};

// Fast fold: candidates arrive in ascending rank, so a value-only >=
// keeps the higher rank on exact ties.
template <typename T>
struct Fold<T, false> {
  static __device__ __forceinline__ void apply(const Consts<T>&, T& dv,
                                               int& dc, T cv, int cc) {
    if (cv >= dv) { dv = cv; dc = cc; }
  }
};

// W + logpLOgLO + logpNoInsgNoIns and W + logpFirstgLO + logpNoInsgNoIns
template <typename T>
__device__ __forceinline__ T add_lolo_nn(const Consts<T>& k, T w) {
  if constexpr (sizeof(T) == 8) return (w + k.lolo) + k.nn;
  else return w + k.lolo_nn;
}
template <typename T>
__device__ __forceinline__ T add_first_nn(const Consts<T>& k, T w) {
  if constexpr (sizeof(T) == 8) return (w + k.first) + k.nn;
  else return w + k.first_nn;
}

// Per-warp shared memory, in this order (T arrays first, bytes last):
//   seq[L_pad], suq[L_pad]   the read's emission terms
//   clpe[CL], clpn[CL]       lpe/lpn at state z, or at RO when z > hl
//                            (CL = 32*R + kMaxNumT covers x + y)
//   src[L_pad]               the read's base codes
__host__ __device__ constexpr int clamped_len(int R) {
  return 32 * R + kMaxNumT;
}
template <typename T>
__host__ __device__ inline size_t warp_smem_bytes(int R, int L_pad) {
  size_t b = sizeof(T) * (2 * (size_t)L_pad + 2 * (size_t)clamped_len(R)) +
             (size_t)L_pad;
  return (b + 15) & ~(size_t)15;
}

// Store one lane's R codes of a step's row (row = first byte of the
// pair's S_half bytes, x0 = lane * R), two per word (low byte first).  R
// is even, so with S_half even every 2-byte word is aligned and lies
// wholly inside or outside the row.
template <int R>
__device__ __forceinline__ void store_codes(uint8_t* row, int x0, int SP,
                                            const int (&word)[R / 2]) {
  if ((SP & 1) == 0) {
#pragma unroll
    for (int p = 0; p < R / 2; ++p)
      if (x0 + 2 * p < SP)
        *reinterpret_cast<uint16_t*>(row + x0 + 2 * p) = (uint16_t)word[p];
  } else {
#pragma unroll
    for (int p = 0; p < R / 2; ++p) {
      if (x0 + 2 * p < SP) row[x0 + 2 * p] = (uint8_t)word[p];
      if (x0 + 2 * p + 1 < SP) row[x0 + 2 * p + 1] = (uint8_t)(word[p] >> 8);
    }
  }
}

// The R codes of a lane as R/2 two-byte words: noins rank c (low
// nibble) plus ins rank ci, which the folds keep already shifted into
// its nibble (ins_shift); slots past the hap end (keep byte 0) take the
// dead code `dead` of both bytes.  The RO slot is rewritten afterwards.
template <int R>
__device__ __forceinline__ void pack_codes(const int (&c)[R],
                                           const int (&ci)[R],
                                           const int (&keep)[R / 2],
                                           int dead, int (&word)[R / 2]) {
#pragma unroll
  for (int p = 0; p < R / 2; ++p) {
    const int w = c[2 * p] + c[2 * p + 1] * 256 + ci[2 * p] + ci[2 * p + 1];
    word[p] = (w & keep[p]) | (dead & ~keep[p]);
  }
}

// ins ranks of slot j, pre-shifted into the ins nibble of its byte
__host__ __device__ constexpr int ins_shift(int j) {
  return 4 + 8 * (j & 1);
}

template <typename T, bool EXACT, int R, int NTM>
__global__ void __launch_bounds__(kWarps * 32)
pair_hmm_dp_warp(const int* __restrict__ hap_len,
                 const int* __restrict__ read_len,
                 const int* __restrict__ b_mid,
                 const uint8_t* __restrict__ read_codes,
                 const uint8_t* __restrict__ hap_codes,
                 const T* __restrict__ eq, const T* __restrict__ uq,
                 const T* __restrict__ lpe, const T* __restrict__ lpn,
                 T* __restrict__ amid, T* __restrict__ bmid,
                 uint8_t* __restrict__ btf, uint8_t* __restrict__ btb, int B,
                 int H_pad, int L_pad, int numT, int L_act, int MB, int MN,
                 Consts<T> k) {
  using F = Fold<T, EXACT>;
  constexpr int NH = NTM - 1;  // largest stencil reach
  // per-candidate costs in registers when they fit (R*NH values)
  constexpr bool HOIST = R * NH * sizeof(T) <= 48 * 4;
  constexpr int HR = HOIST ? R : 1;
  constexpr int HY = HOIST ? NH : 1;
  static_assert(R % 2 == 0 && R <= 32 && NTM <= kMaxNumT, "shape");

  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= B) return;  // the whole warp leaves together

  // the main path's kernels are built for numT = NTM exactly; the
  // generic ones (NTM = 15) take any numT <= 15
  const int nT = NTM == kMaxNumT ? numT : NTM;
  const int SP = H_pad + 2;
  const int RO = SP - 1;
  const int CL = clamped_len(R);
  unsigned char* wsm = smem + warp * warp_smem_bytes<T>(R, L_pad);
  T* seq = reinterpret_cast<T*>(wsm);
  T* suq = seq + L_pad;
  T* clpe = suq + L_pad;
  T* clpn = clpe + CL;
  uint8_t* src = reinterpret_cast<uint8_t*>(clpn + CL);

  const int hl = hap_len[pair];
  const int rl = read_len[pair];
  const int bm = b_mid[pair];
  const size_t prow = (size_t)pair * SP;
  const size_t lrow = (size_t)pair * L_pad;
  const T lpeRO = lpe[prow + RO];
  const T lpnRO = lpn[prow + RO];
  const T lpeH = lpe[prow + hl];
  for (int i = lane; i < L_pad; i += 32) {
    seq[i] = eq[lrow + i];
    suq[i] = uq[lrow + i];
    src[i] = read_codes[lrow + i];
  }
  for (int i = lane; i < CL; i += 32) {
    T ce = lpeRO, cn = lpnRO;
    if (i <= hl) {
      ce = lpe[prow + i];
      cn = lpn[prow + i];
    }
    clpe[i] = ce;
    clpn[i] = cn;
  }

  // lane constants: states x = x0 + j
  const int x0 = lane * R;
  T lpe_r[R], lpn_r[R], lpe1_r[R];
  int hq[R];  // hap base where a mismatch can occur, else -1
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int x = x0 + j;
    lpe_r[j] = T(0);
    lpn_r[j] = T(0);
    lpe1_r[j] = T(0);
    if (x < SP) {
      lpe_r[j] = lpe[prow + x];
      lpn_r[j] = lpn[prow + x];
    }
    if (x + 1 < SP) lpe1_r[j] = lpe[prow + x + 1];
    int h = -1;
    if (x >= 1 && x <= hl) {
      const int c = hap_codes[(size_t)pair * H_pad + x - 1];
      if (c != kN) h = c;
    }
    hq[j] = h;
  }
  // live states of this lane are j < live_n (x <= hl); RO is slot ro_j
  // of lane RO / R; the hap end hl is slot jh of lane lane_h
  const int live_n = min(max(hl + 1 - x0, 0), R);
  const int ro_j = (lane == RO / R) ? RO % R : -1;
  const int lane_h = hl / R;
  const int jh = hl % R;
  int keep[R / 2];  // 0xff per byte of a live slot (x <= hl)
#pragma unroll
  for (int p = 0; p < R / 2; ++p)
    keep[p] = (x0 + 2 * p <= hl ? 0xff : 0) | (x0 + 2 * p + 1 <= hl ? 0xff00 : 0);
  const T negbig = k.negbig;
  T* amid_p = amid + (size_t)pair * 2 * SP;
  T* bmid_p = bmid + (size_t)pair * 2 * SP;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int x = x0 + j;
    if (x < SP) {
      amid_p[x] = T(0);
      amid_p[SP + x] = T(0);
      bmid_p[x] = T(0);
      bmid_p[SP + x] = T(0);
    }
  }
  __syncwarp();

  T an[R], ai[R], Wn[R], Wi[R];
  int word[R / 2];
  T hc[NH];  // halo: Wn of the NH states past this lane's run
  T cost[HY][HR];

  // ---------------- forward (Dec) pass: b = 1..MB ----------------
  if constexpr (HOIST) {
#pragma unroll
    for (int y = 1; y <= NH; ++y)
#pragma unroll
      for (int j = 0; j < R; ++j)
        cost[y - 1][j] = (y == 1) ? lpn_r[j] : lpe_r[j] + k.ky[y];
  }
#pragma unroll
  for (int j = 0; j < R; ++j) { an[j] = T(0); ai[j] = T(0); }
  T aRO = T(0), iRO = T(0);
  for (int b = 1; b <= MB; ++b) {
    const int rb = src[b - 1];
    const T e = seq[b - 1];
    const T u = suq[b - 1];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      Wn[j] = an[j] + ((hq[j] >= 0 && hq[j] != rb) ? u : e);
      Wi[j] = ai[j] + e;
    }
    const T WnRO = aRO + e;
    const T WiRO = iRO + e;
    const T Wn0 = __shfl_sync(kFull, Wn[0], 0);
    T sn = Wn[0], si = Wi[0];
#pragma unroll
    for (int j = 1; j < R; ++j)
      if (j == jh) { sn = Wn[j]; si = Wi[j]; }
    const T WnH = __shfl_sync(kFull, sn, lane_h);
    const T WiH = __shfl_sync(kFull, si, lane_h);
    // halo: hc[y-1] = Wn[x0 - y], Wn0 below state 0
#pragma unroll
    for (int y = 1; y <= NH; ++y) {
      const int d = (y + R - 1) / R;
      const T v = __shfl_up_sync(kFull, Wn[R - 1 - (y - 1) % R], d);
      hc[y - 1] = lane >= d ? v : Wn0;
    }
    const T wim1 = __shfl_up_sync(kFull, Wi[R - 1], 1);

    // interior noins: ins exit x-1 (0) > self (1) > del x-y (1+y)
    T v[R];
    int c[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const T srcWi = j > 0 ? Wi[j - 1] : wim1;
      if constexpr (EXACT) {
        v[j] = negbig; c[j] = 1;
      } else {
        v[j] = srcWi + lpe_r[j]; c[j] = 0;
        F::apply(k, v[j], c[j], negbig, 1);
      }
    }
#pragma unroll
    for (int y = 1; y <= NH; ++y) {
      if (y < nT) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const T s = j >= y ? Wn[j - y] : hc[y - j - 1];
          T lp;
          if constexpr (HOIST) lp = cost[y - 1][j];
          else lp = (y == 1) ? lpn_r[j] : lpe_r[j] + k.ky[y];
          F::apply(k, v[j], c[j], (s + lp) + lpn_r[j], 1 + y);
        }
      }
    }
    if constexpr (EXACT) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        F::apply(k, v[j], c[j], (j > 0 ? Wi[j - 1] : wim1) + lpe_r[j], 0);
    }
    // insertion lanes: extension (0) then open from noins x (1)
    int ci[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T vi = Wi[j] + k.lpig;
      ci[j] = 0;
      F::apply(k, vi, ci[j], Wn[j] + k.nig, 1 << ins_shift(j));
      an[j] = v[j];
      ai[j] = vi;
    }
    // state 0 (lane 0, slot 0): noins from itself; ins open not allowed
    {
      T vi0 = Wi[0] + k.lpig;
      int ci0 = 0;
      F::apply(k, vi0, ci0, negbig, 0);
      if (lane == 0) {
        an[0] = Wn[0] + k.nn;
        ai[0] = vi0;
        c[0] = 1;
        ci[0] = ci0;
      }
    }
    // RO, on every lane
    T vRO;
    int cRO;
    if constexpr (EXACT) {
      vRO = add_lolo_nn(k, WnRO); cRO = 2;
      F::apply(k, vRO, cRO, add_first_nn(k, WnH), 3);
      F::apply(k, vRO, cRO, (WiRO + k.lolo) + lpeRO, 0);
      F::apply(k, vRO, cRO, (WiH + k.first) + lpeH, 1);
    } else {
      vRO = (WiRO + k.lolo) + lpeRO; cRO = 0;
      F::apply(k, vRO, cRO, (WiH + k.first) + lpeH, 1);
      F::apply(k, vRO, cRO, add_lolo_nn(k, WnRO), 2);
      F::apply(k, vRO, cRO, add_first_nn(k, WnH), 3);
    }
    T viRO = WiRO + k.lpig;
    int ciRO = 0;
    F::apply(k, viRO, ciRO, WnRO + k.nig, 1);
    aRO = vRO;
    iRO = viRO;
    const int codeRO = cRO | (ciRO << 4);

    // dead states (hl < x < RO): noins 1, ins 0, values -1e30; then RO
    pack_codes<R>(c, ci, keep, 0x0101, word);
    uint8_t* row = btf + ((size_t)(b - 1) * B + pair) * SP;
    store_codes<R>(row, x0, SP, word);
    __syncwarp();
    if (lane == 0) row[RO] = (uint8_t)codeRO;
    if (bm == b) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int x = x0 + j;
        if (x < SP) {
          const bool lv = j < live_n, ro = j == ro_j;
          amid_p[x] = lv ? an[j] : (ro ? aRO : negbig);
          amid_p[SP + x] = lv ? ai[j] : (ro ? iRO : negbig);
        }
      }
    }
  }

  // ---------------- backward (Inc) pass: b = L_act-1 .. MN+1 ----------
  if constexpr (HOIST) {
    // cost[y-1][j] = lp + s_lpn at clamp(x+y), from the clamped rows
#pragma unroll
    for (int y = 1; y <= NH; ++y)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const T sn_ = clpn[x0 + j + y];
        const T lp = (y == 1) ? sn_ : clpe[x0 + j + y] + k.ky[y];
        cost[y - 1][j] = lp + sn_;
      }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) { an[j] = T(0); ai[j] = T(0); }
  aRO = T(0);
  iRO = T(0);
  const T zero = T(0);
  for (int b = L_act - 1; b > MN; --b) {
    const int rb = src[b];
    const T e = seq[b];
    const T u = suq[b];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      Wn[j] = an[j] + ((hq[j] >= 0 && hq[j] != rb) ? u : e);
      Wi[j] = ai[j] + e;
    }
    const T WnRO = aRO + e;
    const T WiRO = iRO + e;
    const T Wn0 = Wn[0];  // raw values for state 0 (lane 0)
    const T Wn1 = Wn[1];
    // clamp: sources past hl read RO
#pragma unroll
    for (int j = 0; j < R; ++j) Wn[j] = j < live_n ? Wn[j] : WnRO;
    // halo: hc[y-1] = clamped Wn[x0 + R - 1 + y], RO past the warp
#pragma unroll
    for (int y = 1; y <= NH; ++y) {
      const int d = (y + R - 1) / R;
      const T v = __shfl_down_sync(kFull, Wn[(y - 1) % R], d);
      hc[y - 1] = lane + d <= 31 ? v : WnRO;
    }

    T v[R];
    int c[R];
    if constexpr (EXACT) {
      // noins ranks: ins x (0) > del clamp(x+y) (numT-y) > self (numT)
#pragma unroll
      for (int j = 0; j < R; ++j) { v[j] = negbig; c[j] = nT; }
#pragma unroll
      for (int y = 1; y <= NH; ++y) {
        if (y < nT) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const T s = j + y < R ? Wn[j + y] : hc[j + y - R];
            T cst;
            if constexpr (HOIST) {
              cst = cost[y - 1][j];
            } else {
              const T sn_ = clpn[x0 + j + y];
              cst = ((y == 1) ? sn_ : clpe[x0 + j + y] + k.ky[y]) + sn_;
            }
            F::apply(k, v[j], c[j], cst + s, nT - y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j)
        F::apply(k, v[j], c[j], Wi[j] + lpe1_r[j], 0);
    } else {
#pragma unroll
      for (int j = 0; j < R; ++j) { v[j] = Wi[j] + lpe1_r[j]; c[j] = 0; }
#pragma unroll
      for (int y = NH; y >= 1; --y) {
        if (y < nT) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            const T s = j + y < R ? Wn[j + y] : hc[j + y - R];
            T cst;
            if constexpr (HOIST) {
              cst = cost[y - 1][j];
            } else {
              const T sn_ = clpn[x0 + j + y];
              cst = ((y == 1) ? sn_ : clpe[x0 + j + y] + k.ky[y]) + sn_;
            }
            F::apply(k, v[j], c[j], cst + s, nT - y);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) F::apply(k, v[j], c[j], negbig, nT);
    }
    // insertion lanes: extension (0), then exit to noins clamp(x+1) (2)
    int ci[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      T vi = Wi[j] + k.lpig;
      ci[j] = 0;
      F::apply(k, vi, ci[j], (j + 1 < R ? Wn[j + 1] : hc[0]) + k.nig,
               2 << ins_shift(j));
      an[j] = v[j];
      ai[j] = vi;
    }
    // state 0 (lane 0, slot 0), from the raw Wn[0], Wn[1]
    {
      const T cand = Wi[0] + lpe1_r[0];
      T v0;
      int c0;
      if constexpr (EXACT) {
        v0 = add_lolo_nn(k, Wn0); c0 = nT;
        F::apply(k, v0, c0, add_first_nn(k, Wn1), nT - 1);
        F::apply(k, v0, c0, cand, 0);
      } else {
        v0 = cand; c0 = 0;
        F::apply(k, v0, c0, add_first_nn(k, Wn1), nT - 1);
        F::apply(k, v0, c0, add_lolo_nn(k, Wn0), nT);
      }
      T vi0 = Wi[0] + k.lpig;
      int ci0 = 0;
      F::apply(k, vi0, ci0, Wn0 + k.nig, 1 << ins_shift(0));
      if (lane == 0) {
        an[0] = v0;
        ai[0] = vi0;
        c[0] = c0;
        ci[0] = ci0;
      }
    }
    // RO, on every lane: insertion open (0) > self (numT)
    T vRO;
    int cRO;
    const T candRO = WiRO + zero;
    if constexpr (EXACT) {
      vRO = WnRO + lpnRO; cRO = nT;
      F::apply(k, vRO, cRO, candRO, 0);
    } else {
      vRO = candRO; cRO = 0;
      F::apply(k, vRO, cRO, WnRO + lpnRO, nT);
    }
    T viRO = WiRO + k.lpig;
    int ciRO = 0;
    F::apply(k, viRO, ciRO, WnRO + k.nig, 2);
    int codeRO = cRO | (ciRO << 4);
    // x=0 reads state 1 raw: keep it at -1e30 when it is dead (hl = 0)
    if (hl == 0) an[1] = negbig;
    // padded-slice rule: beta[b-1] = 0 when b-1 >= read_len-1
    const bool pad = b - 1 >= rl - 1;
    if (pad) {
#pragma unroll
      for (int j = 0; j < R; ++j) { an[j] = zero; ai[j] = zero; }
      vRO = zero;
      viRO = zero;
      codeRO = nT;
    }
    aRO = vRO;
    iRO = viRO;
    // dead states (hl < x < RO), and every state under the pad rule:
    // noins numT, ins 0; then RO
    const int dead = nT * 0x0101;
    if (pad) {
#pragma unroll
      for (int p = 0; p < R / 2; ++p) word[p] = dead;
    } else {
      pack_codes<R>(c, ci, keep, dead, word);
    }
    uint8_t* row = btb + ((size_t)(b - 1) * B + pair) * SP;
    store_codes<R>(row, x0, SP, word);
    __syncwarp();
    if (lane == 0) row[RO] = (uint8_t)codeRO;
    if (bm == b - 1) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int x = x0 + j;
        if (x < SP) {
          const bool lv = pad || j < live_n, ro = j == ro_j;
          bmid_p[x] = lv ? an[j] : (ro ? aRO : negbig);
          bmid_p[SP + x] = lv ? ai[j] : (ro ? iRO : negbig);
        }
      }
    }
  }
}

template <typename T>
Consts<T> make_consts(double lolo, double first, double lpig, double nig,
                      double nn, int numT) {
  Consts<T> k;
  k.eps = T(kEPS);
  k.tie = T(kTIE);
  k.negbig = T(kNEGBIG);
  k.lolo = T(lolo);
  k.first = T(first);
  k.lpig = T(lpig);
  k.nig = T(nig);
  k.nn = T(nn);
  k.lolo_nn = T(lolo + nn);
  k.first_nn = T(first + nn);
  for (int y = 0; y <= kMaxNumT; ++y) k.ky[y] = T(0);
  for (int y = 2; y < numT; ++y) k.ky[y] = T((y - 1) * lpig);
  return k;
}

template <typename T, bool EXACT, int R, int NTM>
int launch_shape(const int* hap_len, const int* read_len, const int* b_mid,
                 const uint8_t* read_codes, const uint8_t* hap_codes,
                 const T* eq, const T* uq, const T* lpe, const T* lpn,
                 T* amid, T* bmid, uint8_t* btf, uint8_t* btb, int B,
                 int H_pad, int L_pad, int numT, int L_act, int MB, int MN,
                 const Consts<T>& k, cudaStream_t s) {
  auto kern = pair_hmm_dp_warp<T, EXACT, R, NTM>;
  const size_t smem = kWarps * warp_smem_bytes<T>(R, L_pad);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (B + kWarps - 1) / kWarps;
  kern<<<blocks, kWarps * 32, smem, s>>>(hap_len, read_len, b_mid,
                                         read_codes, hap_codes, eq, uq, lpe,
                                         lpn, amid, bmid, btf, btb, B, H_pad,
                                         L_pad, numT, L_act, MB, MN, k);
  return (int)cudaGetLastError();
}

template <typename T, bool EXACT>
int launch(const int* hap_len, const int* read_len, const int* b_mid,
           const uint8_t* read_codes, const uint8_t* hap_codes, const T* eq,
           const T* uq, const T* lpe, const T* lpn, T* amid, T* bmid,
           uint8_t* btf, uint8_t* btb, int B, int H_pad, int L_pad, int numT,
           int L_act, int MB, int MN, double lolo, double first, double lpig,
           double nig, double nn, void* stream) {
  const int SP = H_pad + 2;
  if (numT < 2 || numT > kMaxNumT || B <= 0 || H_pad < 0 || SP > 32 * 32 ||
      L_pad < 2 || L_act > L_pad)
    return (int)cudaErrorInvalidValue;
  const Consts<T> k = make_consts<T>(lolo, first, lpig, nig, nn, numT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DINDEL_DP_ARGS                                                     \
  hap_len, read_len, b_mid, read_codes, hap_codes, eq, uq, lpe, lpn, amid, \
      bmid, btf, btb, B, H_pad, L_pad, numT, L_act, MB, MN, k, s
  // kernels for numT = 7 exactly (the default --maxLengthIndel 5) at
  // S_half <= 256; the generic numT <= 15 ones elsewhere
  const bool short_reach = numT == 7;
  if (SP <= 32 * 2)
    return short_reach ? launch_shape<T, EXACT, 2, 7>(DINDEL_DP_ARGS)
                       : launch_shape<T, EXACT, 2, kMaxNumT>(DINDEL_DP_ARGS);
  if (SP <= 32 * 4)
    return short_reach ? launch_shape<T, EXACT, 4, 7>(DINDEL_DP_ARGS)
                       : launch_shape<T, EXACT, 4, kMaxNumT>(DINDEL_DP_ARGS);
  if (SP <= 32 * 6)
    return short_reach ? launch_shape<T, EXACT, 6, 7>(DINDEL_DP_ARGS)
                       : launch_shape<T, EXACT, 6, kMaxNumT>(DINDEL_DP_ARGS);
  if (SP <= 32 * 8)
    return short_reach ? launch_shape<T, EXACT, 8, 7>(DINDEL_DP_ARGS)
                       : launch_shape<T, EXACT, 8, kMaxNumT>(DINDEL_DP_ARGS);
  if (SP <= 32 * 16)
    return launch_shape<T, EXACT, 16, kMaxNumT>(DINDEL_DP_ARGS);
  return launch_shape<T, EXACT, 32, kMaxNumT>(DINDEL_DP_ARGS);
#undef DINDEL_DP_ARGS
}

}  // namespace

#if DINDEL_DP_DOUBLE
typedef double dp_real;
#define DINDEL_DP_TYPE f64
#else
typedef float dp_real;
#define DINDEL_DP_TYPE f32
#endif
#if DINDEL_DP_EXACT
#define DINDEL_DP_FOLD exact
#else
#define DINDEL_DP_FOLD fast
#endif
#define DINDEL_DP_NAME2(t, f) dindel_pair_hmm_dp_##t##_##f
#define DINDEL_DP_NAME(t, f) DINDEL_DP_NAME2(t, f)
#define DINDEL_DP_ENTRY DINDEL_DP_NAME(DINDEL_DP_TYPE, DINDEL_DP_FOLD)

// dindel_pair_hmm_dp_{f32,f64}_{fast,exact}: 0 on a launched kernel, else
// the CUDA error code.  btf/btb are (L_pad-1, B, H_pad+2) uint8.
extern "C" int DINDEL_DP_ENTRY(
    const int* hap_len, const int* read_len, const int* b_mid,
    const uint8_t* read_codes, const uint8_t* hap_codes, const dp_real* eq,
    const dp_real* uq, const dp_real* lpe, const dp_real* lpn, dp_real* amid,
    dp_real* bmid, uint8_t* btf, uint8_t* btb, int B, int H_pad, int L_pad,
    int numT, int L_act, int MB, int MN, double lolo, double first,
    double lpig, double nig, double nn, void* stream) {
  return launch<dp_real, DINDEL_DP_EXACT != 0>(
      hap_len, read_len, b_mid, read_codes, hap_codes, eq, uq, lpe, lpn, amid,
      bmid, btf, btb, B, H_pad, L_pad, numT, L_act, MB, MN, lolo, first, lpig,
      nig, nn, stream);
}
