// The training forward of the flash attention kernels: the instances of
// flash_attention.cu that also write each row's log-sum-exp (LSE = true,
// entry point fa_forward_lse), in a library of their own so that nvcc
// builds them beside serving's instances, in parallel.
#define FA_TRAINING 1
#include "flash_attention.cu"
