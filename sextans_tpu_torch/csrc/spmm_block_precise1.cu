// spmm_block_precise1: the block kernel (K3, spmm_block.cuh) at precise
// level 1, every block width, compiled apart from spmm_block.cu.

#include "spmm_block.cuh"

template cudaError_t sx_block::launch_level<1>(int, const sx_block::Args&);
