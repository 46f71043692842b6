// Phase kernels of the slab epilogue's pair_stats (K3) and window_call
// (K4), for timing their phases apart on the card
// (tools/epilogue_phases_torch.py).  They are composed from the shipped
// kernels' own device functions in dindel_tpu_torch/csrc/slab_epilogue.cu,
// which this file includes, so the shipped source keeps no measurement
// switch.  Their outputs are not the kernels' outputs and are not read:
// pair_stats's staging phase stages the pairs' scalars, rows, hap codes
// and slot tables and writes the (unset) staged outputs, no column pass,
// slot tests or sums;
// window_call's which 0 runs the gathers and the t values, no sums;
// which 1 the in-order sums over zeroed t values, no gathers and no t.

#include "../dindel_tpu_torch/csrc/slab_epilogue.cu"

namespace {

template <typename T>
__global__ void __launch_bounds__(kWinThreads, kWinBlocksPerSM)
window_terms_only(void* const* p, int NH, int S, int NR, int KT, int R,
                  T log5) {
  extern __shared__ __align__(16) unsigned char smem[];
  WindowBlock<T> b(smem, WindowSmem{KT, R, S, sizeof(T)}, (const int*)p[1],
                   (const int*)p[2], NH, NR);
  const T* pair_pr = (const T*)p[3];
  const int t = threadIdx.x;
  const T mine = t < b.nacc ? b.seed(pair_pr, t) : T(0);
  b.pairs();
  __syncthreads();
  b.put_seeds(pair_pr, mine);
  for (int r0 = 0; r0 < b.nr; r0 += R) {
    b.terms((const T*)p[0], r0, min(R, b.nr - r0), log5);
    __syncthreads();
  }
  b.write((T*)p[4], (T*)p[5]);
}

template <typename T>
__global__ void __launch_bounds__(kWinThreads, kWinBlocksPerSM)
window_sums_only(void* const* p, int NH, int S, int NR, int KT, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  WindowBlock<T> b(smem, WindowSmem{KT, R, S, sizeof(T)}, (const int*)p[1],
                   (const int*)p[2], NH, NR);
  const T* pair_pr = (const T*)p[3];
  const int t = threadIdx.x;
  const T mine = t < b.nacc ? b.seed(pair_pr, t) : T(0);
  for (int e = t; e < KT * (R + 1); e += kWinThreads) b.tv[e] = T(0);
  b.put_seeds(pair_pr, mine);
  __syncthreads();
  for (int r0 = 0; r0 < b.nr; r0 += R) {
    b.sums(min(R, b.nr - r0));
    __syncthreads();
  }
  b.write((T*)p[4], (T*)p[5]);
}

template <typename T>
int window_phase(int which, void* const* p, int W, int NH, int S, int NR,
                 double log5, cudaStream_t st) {
  const int NP = NH * (NH + 1) / 2;
  const WindowSmem lay = window_shape(W, NP, S, NR, sizeof(T));
  const dim3 grid((unsigned)((NP + lay.KT - 1) / lay.KT), (unsigned)W);
  if (which == 0) {
    auto k = window_terms_only<T>;
    cudaError_t err = allow_smem(k, lay.total());
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kWinThreads, lay.total(), st>>>(p, NH, S, NR, lay.KT, lay.R,
                                              (T)log5);
  } else {
    auto k = window_sums_only<T>;
    cudaError_t err = allow_smem(k, lay.total());
    if (err != cudaSuccess) return (int)err;
    k<<<grid, kWinThreads, lay.total(), st>>>(p, NH, S, NR, lay.KT, lay.R);
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kStatThreads)
stats_stage_only(void* const* p, int B, int H_pad, int L_pad, int V, int P) {
  extern __shared__ __align__(16) unsigned char smem[];
  StatsBlock b(smem, StatsSmem{P, L_pad, H_pad, V}, B);
  b.stage((const int*)p[0], (const int*)p[1], (const int*)p[2],
          (const int64_t*)p[3], (const int64_t*)p[4], (const uint8_t*)p[5],
          (const uint8_t*)p[6], (const uint8_t*)p[7], (const uint8_t*)p[8],
          (const double*)p[9], (const int*)p[10], (const int*)p[11],
          (const uint8_t*)p[12], (const uint8_t*)p[13],
          (const uint8_t*)p[14]);
  b.write((int*)p[15], (double*)p[16], (uint8_t*)p[17], (uint8_t*)p[18], B);
}

}  // namespace

// dindel_stats_stage_phase: `p` (device memory) holds dindel_pair_stats's
// 19 pointers; the staging phase above, launched as pair_stats is.  0 on
// a launched kernel, else the CUDA error code.
extern "C" int dindel_stats_stage_phase(void* const* p, int B, int H_pad,
                                        int L_pad, int V, void* stream) {
  const StatsSmem lay = pair_stats_shape(B, H_pad, L_pad, V);
  if (B <= 0 || lay.P == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(stats_stage_only, lay.total());
  if (err != cudaSuccess) return (int)err;
  stats_stage_only<<<(unsigned)((B + lay.P - 1) / lay.P), kStatThreads,
                     lay.total(), static_cast<cudaStream_t>(stream)>>>(
      p, B, H_pad, L_pad, V, lay.P);
  return (int)cudaGetLastError();
}

// dindel_window_phase: `p` (device memory) holds window_call's 6
// pointers; which 0 or 1 as above.  0 on a launched kernel, else the
// CUDA error code.
extern "C" int dindel_window_phase(int which, int dbl, void* const* p,
                                   int W, int NH, int S, int NR,
                                   double log5, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dbl ? window_phase<double>(which, p, W, NH, S, NR, log5, st)
             : window_phase<float>(which, p, W, NH, S, NR, log5, st);
}
