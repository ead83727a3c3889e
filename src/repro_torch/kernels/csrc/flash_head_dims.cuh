// The one list of (D, Dv) pairs the flash attention kernels are
// instantiated for, forward (flash_attention.cu) and backward
// (flash_attention_bwd.cu), in both dtypes: every multiple of 16 up to 256
// with Dv = D, and MLA's 192 / 128.  flash_attention.py reads it from here
// (supported_head_dims).
#pragma once

#define FA_HEAD_DIMS(X)                                                     \
  X(16, 16) X(32, 32) X(48, 48) X(64, 64) X(80, 80) X(96, 96) X(112, 112)  \
  X(128, 128) X(144, 144) X(160, 160) X(176, 176) X(192, 192) X(208, 208) \
  X(224, 224) X(240, 240) X(256, 256) X(192, 128)
