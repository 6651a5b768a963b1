// The attention backward's tensor-core route (flash_bwd_wgmma.cuh) with P
// and dS rounded to bf16 alone as the A operands of dV += P^T dO, dK += dS^T
// Q and dQ += dS K, where flash_attention_bwd.cu splits each into bf16 hi +
// lo. Rounded so, dk and dv leave chip_smoke.py's BWD_TOL at several shapes;
// no path of the port calls this. Phase 2 of chip_smoke.py times it beside
// the split route: what the split costs. A source of its own so that nvcc
// builds it beside flash_attention_bwd.cu.

#include "flash_bwd_wgmma.cuh"

// As flash_attention_bwd_wgmma (flash_attention_bwd.cu).
extern "C" int flash_attention_bwd_wgmma_unsplit(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    void* dq, void* dk, void* dv, const float* lse, float* scratch, int B, int S, int Hq,
    int Hkv, int dh, int dhv, int64_t qsb, int64_t qss, int64_t qsh, int64_t ksb,
    int64_t kss, int64_t ksh, int64_t vsb, int64_t vss, int64_t vsh, int64_t osb,
    int64_t oss, int64_t osh, int64_t gsb, int64_t gss, int64_t gsh, float scale,
    int causal, int window, void* stream) {
  return repro_kernels::flash_bwd_tc::entry<false>(
      q, k, v, o, dout, dq, dk, dv, lse, scratch, B, S, Hq, Hkv, dh, dhv, qsb, qss, qsh, ksb,
      kss, ksh, vsb, vss, vsh, osb, oss, osh, gsb, gss, gsh, scale, causal, window, stream);
}
