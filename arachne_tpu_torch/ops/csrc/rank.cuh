// occ4 of one BWT row: the device routine of kernel K5 (rank.cu), inlined
// into the seeding state machines S1 and S3 (seed.cu).
//
// Layout (arachne_tpu/index/build.py, uploaded as it is): occ holds the
// checkpoint counts of A, C, G, T before each 128-base block, one row of
// four T per block; words holds the BWT at 16 bases per uint32, first base
// in the top two bits, eight words per block.  T is int for indexes under
// 2^31 rows and long long above (the wide tables).
//
// What bounds it on an H100: one dependent random gather per query (the
// checkpoint row, 16 or 32 bytes, and the block's words, one 32-byte
// sector).  A table of a few MB stays in the 50 MB L2; a GRCh38-sized one
// (about 3.1 GB) does not, and each query then costs two trips to HBM.
//
// Design: the TPU kernel DMA'd one 512-byte padded row per query, a limit
// of Mosaic's DMA; here a thread reads the planar tables directly, only the
// words up to the one holding the row, and counts with __popc.
#pragma once

#include <cstdint>

__device__ __forceinline__ void arachne_count_word(uint32_t y, int cnt[4]) {
    const uint32_t lane = 0x55555555u;
    const uint32_t ny = ~y;
    cnt[0] += __popc((ny >> 1) & ny & lane);
    cnt[1] += __popc((ny >> 1) & y & lane);
    cnt[2] += __popc((y >> 1) & ny & lane);
    cnt[3] += __popc((y >> 1) & y & lane);
}

// Occ(k, c) for c = 0..3 (bwt.c:107-186, arachne_tpu/ops/fm_rank.py:88):
// k == -1 -> 0; k == seq_len -> L2[c+1] - L2[c]; otherwise the row
// k - (k >= primary), clamped into [0, seq_len - 1] as the reference does.
template <typename T>
__device__ __forceinline__ void arachne_occ4(
    const T* __restrict__ occ, const uint32_t* __restrict__ words,
    const T (&L2)[5], T primary, T seq_len, T k, T (&out)[4])
{
    if (k == seq_len) {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = L2[c + 1] - L2[c];
        return;
    }
    if (k == -1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = 0;
        return;
    }
    T kk = k - (k >= primary ? 1 : 0);
    kk = kk < 0 ? 0 : (kk > seq_len - 1 ? seq_len - 1 : kk);
    const T block = kk >> 7;
    const int j = (int)(kk & 127);
    const int wi = j >> 4;    // word holding row kk
    const int p = j & 15;     // its base within that word
    const uint32_t* w = words + block * 8;
    int cnt[4] = {0, 0, 0, 0};
    for (int x = 0; x < wi; ++x) arachne_count_word(__ldg(w + x), cnt);
    // keep bases 0..p of word wi: the shift is 2 * (15 - p) <= 30, so the
    // undefined 32-bit shift of the reference's nvalid == 0 case never
    // arises; words past wi are not read at all
    arachne_count_word(__ldg(w + wi) & ~((1u << (2 * (15 - p))) - 1u), cnt);
    // the 15 - p masked-off bases of word wi read as A; the reference also
    // counts 16 per unread word and subtracts them again (127 - j in all)
    cnt[0] -= 15 - p;
    const T* o = occ + block * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) out[c] = __ldg(o + c) + (T)cnt[c];
}
