// spmm_block: the C entry point of the block kernel (K3, spmm_block.cuh)
// and its plain-mode instantiations; the precise levels are compiled apart
// in spmm_block_precise1.cu and spmm_block_precise2.cu.

#include "spmm_block.cuh"

namespace sx_block {
extern template cudaError_t launch_level<1>(int, const Args&);
extern template cudaError_t launch_level<2>(int, const Args&);
}  // namespace sx_block

extern "C" int spmm_block_launch(
    const void* vals, const void* bcol, const void* group_kwin,
    const void* stripe_ptr, const void* visits, const void* b, const void* c,
    void* out, int n_stripes, int n, int window_k, int block_k,
    int group_blocks, float alpha, float beta, int with_c, int precise,
    int lanes, int vec, int threads, int grid_x, int grid_y, int smem,
    void* stream) {
  const int cpt = lanes == 16 ? 1 : 4;
  if ((lanes != 16 && lanes != 32) || grid_x != n_stripes ||
      (long long)grid_y * lanes * cpt < n)
    return cudaErrorInvalidValue;
  const sx_block::Args a{
      (const float*)vals, (const int*)bcol, (const int*)group_kwin,
      (const int*)stripe_ptr, (const int*)visits, (const float*)b,
      (const float*)c, (float*)out, n, window_k, group_blocks, alpha, beta,
      with_c, lanes, vec, threads, grid_x, grid_y, smem, (cudaStream_t)stream};
  switch (precise) {
    case 0: return sx_block::launch_level<0>(block_k, a);
    case 1: return sx_block::launch_level<1>(block_k, a);
    case 2: return sx_block::launch_level<2>(block_k, a);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* sx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
