// K5: batched occ4 rank queries, one thread per query.
//
// Replaces the TPU kernel arachne_tpu/ops/pallas_gather.py::_rank_kernel
// (through _rank_call and PallasRankTable.occ4).  That kernel took
// interior rows only and left the primary adjustment and the -1 / seq_len
// edges to its caller; this one takes the whole occ4_device contract
// (arachne_tpu/ops/fm_rank.py:88), so its plain version is
// arachne_tpu_torch/ops/fm_rank.py::occ4_torch.  Cost and design: see
// rank.cuh.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

template <typename T>
__global__ void rank_kernel(
    const T* __restrict__ occ, const uint32_t* __restrict__ words,
    const T* __restrict__ L2_g, T primary, T seq_len,
    const T* __restrict__ ks, long long n, T* __restrict__ out)
{
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    T L2[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) L2[c] = __ldg(L2_g + c);
    T r[4];
    arachne_occ4<T>(occ, words, L2, primary, seq_len, ks[q], r);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[q * 4 + c] = r[c];
}

template <typename T>
int launch_rank(const void* occ, const void* words, const void* L2, long long primary,
                long long seq_len, const void* ks, long long n, void* out, void* stream)
{
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    rank_kernel<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const T*)occ, (const uint32_t*)words, (const T*)L2, (T)primary, (T)seq_len,
        (const T*)ks, n, (T*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// ks (n,) and out (n, 4) in the tables' row type: int32, or int64 when
// wide != 0.
extern "C" int arachne_rank(
    const void* occ, const void* words, const void* L2, long long primary,
    long long seq_len, int wide, const void* ks, long long n, void* out, void* stream)
{
    if (n <= 0) return 0;
    if (wide)
        return launch_rank<long long>(occ, words, L2, primary, seq_len, ks, n, out, stream);
    return launch_rank<int>(occ, words, L2, primary, seq_len, ks, n, out, stream);
}
