// spmm_block: the C entry point of the block kernel (K3, spmm_block.cuh)
// and its plain-mode instantiations; the precise levels are compiled apart
// in spmm_block_precise1.cu and spmm_block_precise2.cu.

#include "spmm_block.cuh"

namespace sx_block {
extern template cudaError_t launch_level<1>(int, const Args&);
extern template cudaError_t launch_level<2>(int, const Args&);
}  // namespace sx_block

extern "C" int spmm_block_launch(
    const void* vals, const void* qrow, const void* bcol,
    const void* group_kwin, const void* tile_ptr, const void* tile_groups,
    const void* b, const void* c, void* out, int n_mtiles, int n, int tile_m,
    int window_k, int block_k, int group_blocks, int tile_n, float alpha,
    float beta, int with_c, int precise, void* stream) {
  const sx_block::Args a{
      (const float*)vals, (const int*)qrow, (const int*)bcol,
      (const int*)group_kwin, (const int*)tile_ptr, (const int*)tile_groups,
      (const float*)b, (const float*)c, (float*)out, n_mtiles, n, tile_m,
      window_k, group_blocks, tile_n, alpha, beta, with_c,
      (cudaStream_t)stream};
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
