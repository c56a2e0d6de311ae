// spmm_block_precise2: the block kernel (K3, spmm_block.cuh) at precise
// level 2, every block width, compiled apart from spmm_block.cu.

#include "spmm_block.cuh"

template cudaError_t sx_block::launch_level<2>(int, const sx_block::Args&);
