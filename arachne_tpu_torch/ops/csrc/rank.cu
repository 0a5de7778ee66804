// K5: batched occ4 rank queries, one thread or a group of four lanes per
// query.
//
// Replaces the TPU kernel arachne_tpu/ops/pallas_gather.py::_rank_kernel
// (through _rank_call and PallasRankTable.occ4).  That kernel took
// interior rows only and left the primary adjustment and the -1 / seq_len
// edges to its caller; this one takes the whole occ4_device contract
// (arachne_tpu/ops/fm_rank.py:88), so its plain version is
// arachne_tpu_torch/ops/fm_rank.py::occ4_torch.
//
// What bounds it on an H100: the random gather of one 64-byte record per
// query (rank.cuh), with the query's read and its 16- or 32-byte result
// write beside it.  On a GRCh38-sized table the records are in HBM.
//
// Design: a table larger than the L2 (its records in HBM) is read by a
// group of four lanes per query, each loading one 16-byte chunk of the
// record, so that one warp-wide 16-byte load serves eight queries and
// touches eight whole lines (one thread per query needs three or four such
// loads, each touching 32 lines).  The lanes that hold words count C, G
// and T in their four words; the three counts, packed into one int, reach
// the whole group by two shuffles; the lanes that hold the checkpoint
// counts finish the query and write the result as whole 16-byte vectors
// (int: lane 0 the row; long long: lanes 0 and 1 half of it each).  A
// table that fits the L2 is read by one thread per query (rank.cuh's
// arachne_occ4_load and arachne_occ4_count): there the group's four times
// as many threads cost more than its fewer, wider loads save (PERF.md).
// Both designs take the table as one array (arachne_rank) or split across
// cards (arachne_rank_sharded, rank.cuh's ArachneShardedTable), and pick
// between them by the whole table's size either way.
#include <cuda_runtime.h>

#include "rank.cuh"

namespace {

constexpr int RANK_THREADS = 256;

template <typename T>
__device__ __forceinline__ void load_L2(const T* __restrict__ L2_g, T (&L2)[5]) {
#pragma unroll
    for (int c = 0; c < 5; ++c) L2[c] = __ldg(L2_g + c);
}

// one thread per query
template <typename T, typename Table>
__global__ void __launch_bounds__(RANK_THREADS) rank_kernel(
    const Table table, const T* __restrict__ L2_g, T primary, T seq_len,
    const T* __restrict__ ks, long long n, T* __restrict__ out)
{
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= n) return;
    T L2[5];
    load_L2(L2_g, L2);
    T r[4];
    arachne_occ4_count<T>(arachne_occ4_load<T>(table, primary, seq_len, ks[q]), L2, seq_len, r);
#pragma unroll
    for (int c = 0; c < 4; ++c) out[q * 4 + c] = r[c];
}

// four lanes per query
template <typename T, typename Table>
__global__ void __launch_bounds__(RANK_THREADS) rank_group_kernel(
    const Table table, const T* __restrict__ L2_g, T primary, T seq_len,
    const T* __restrict__ ks, long long n, T* __restrict__ out)
{
    constexpr int CC = arachne_count_chunks<T>();
    const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 2;
    const int lane = threadIdx.x & 3;
    // a group past the end runs on a row of its own (row 0) so that every
    // lane of the warp takes part in the shuffles, and stores nothing
    const bool valid = q < n;
    const T k = valid ? ks[q] : (T)0;
    const T kk = arachne_occ4_row(primary, seq_len, k);
    const int j = (int)(kk & 127);
    const uint4 v = lane < CC + 2 ? arachne_ld16(arachne_record(table, kk >> 7) + lane)
                                  : make_uint4(0, 0, 0, 0);
    // lanes CC and CC + 1 hold words 0-3 and 4-7; every other lane's masks
    // are 0 and it counts nothing
    const int h = lane - CC;
    const bool words = h == 0 || h == 1;
    int c1 = 0, c2 = 0, c3 = 0;
    arachne_count_pair(v.x & (words ? arachne_word_mask(4 * h, j) : 0u),
                       v.y & (words ? arachne_word_mask(4 * h + 1, j) : 0u), c1, c2, c3);
    arachne_count_pair(v.z & (words ? arachne_word_mask(4 * h + 2, j) : 0u),
                       v.w & (words ? arachne_word_mask(4 * h + 3, j) : 0u), c1, c2, c3);
    // each count is at most 128: ten bits apiece
    int packed = c1 | (c2 << 10) | (c3 << 20);
    packed += __shfl_xor_sync(0xffffffffu, packed, 1);
    packed += __shfl_xor_sync(0xffffffffu, packed, 2);
    c1 = packed & 1023;
    c2 = (packed >> 10) & 1023;
    c3 = packed >> 20;
    if (!valid || lane >= CC) return;
    T L2[5];
    load_L2(L2_g, L2);
    if constexpr (sizeof(T) == 4) {
        int r[4];
        const int base[4] = {(int)v.x, (int)v.y, (int)v.z, (int)v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
            r[c] = arachne_occ4_finish<int>(c, base[c], j, c1, c2, c3, L2, seq_len, k);
        reinterpret_cast<uint4*>(out)[q] =
            make_uint4((uint32_t)r[0], (uint32_t)r[1], (uint32_t)r[2], (uint32_t)r[3]);
    } else {
        // lane h (0 or 1) holds counts 2h and 2h + 1 (each base's count
        // taken with a constant base, so that L2 is never indexed at run
        // time, which would put it in local memory)
        const long long b0 = arachne_join64(v.x, v.y), b1 = arachne_join64(v.z, v.w);
        const long long r0 = lane == 0
            ? arachne_occ4_finish<long long>(0, b0, j, c1, c2, c3, L2, seq_len, k)
            : arachne_occ4_finish<long long>(2, b0, j, c1, c2, c3, L2, seq_len, k);
        const long long r1 = lane == 0
            ? arachne_occ4_finish<long long>(1, b1, j, c1, c2, c3, L2, seq_len, k)
            : arachne_occ4_finish<long long>(3, b1, j, c1, c2, c3, L2, seq_len, k);
        reinterpret_cast<uint4*>(out)[q * 2 + lane] = make_uint4(
            (uint32_t)r0, (uint32_t)((unsigned long long)r0 >> 32),
            (uint32_t)r1, (uint32_t)((unsigned long long)r1 >> 32));
    }
}

// Does the record table of an index of seq_len rows (one record per
// 128-base block and one past the end) exceed the current device's L2?
bool beyond_l2(long long seq_len) {
    int dev = 0, l2 = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, dev);
    return ((seq_len + 127) / 128 + 1) * 64 > (long long)l2;
}

template <typename T, typename Table>
int launch_rank(Table table, const void* L2, long long primary, long long seq_len,
                const void* ks, long long n, void* out, void* stream)
{
    if (n <= 0) return 0;
    const int lanes = beyond_l2(seq_len) ? 4 : 1;
    const long long blocks = (n * lanes + RANK_THREADS - 1) / RANK_THREADS;
    auto kernel = lanes == 4 ? rank_group_kernel<T, Table> : rank_kernel<T, Table>;
    kernel<<<(unsigned)blocks, RANK_THREADS, 0, (cudaStream_t)stream>>>(
        table, (const T*)L2, (T)primary, (T)seq_len, (const T*)ks, n, (T*)out);
    return (int)cudaGetLastError();
}

}  // namespace

// table: the record table (64 bytes a record, on 64 bytes); ks (n,) and out
// (n, 4) in the tables' row type: int32, or int64 when wide != 0.
extern "C" int arachne_rank(
    const void* table, const void* L2, long long primary, long long seq_len, int wide,
    const void* ks, long long n, void* out, void* stream)
{
    const ArachneFlatTable t{(const uint4*)table};
    if (wide) return launch_rank<long long>(t, L2, primary, seq_len, ks, n, out, stream);
    return launch_rank<int>(t, L2, primary, seq_len, ks, n, out, stream);
}

// arachne_rank on a table split across cards: shards, an array on the
// launching card, holds the address of each range of ``per`` records (the
// last range padded with zero records), each on 64 bytes; a range on
// another card needs peer access to it (arachne_enable_peer_access).
extern "C" int arachne_rank_sharded(
    const void* shards, long long per, const void* L2, long long primary, long long seq_len,
    int wide, const void* ks, long long n, void* out, void* stream)
{
    const auto s = (const uint4* const*)shards;
    if (wide)
        return launch_rank<long long>(ArachneShardedTable<long long>{s, per}, L2, primary,
                                      seq_len, ks, n, out, stream);
    return launch_rank<int>(ArachneShardedTable<int>{s, (int)per}, L2, primary, seq_len, ks, n,
                            out, stream);
}

// Let kernels launched on card ``device`` read the memory of card ``peer``
// (cudaDeviceEnablePeerAccess; enabling it twice is no error).  Returns
// cudaErrorPeerAccessUnsupported where the pair cannot: the caller raises,
// and never copies the peer's memory over instead.
extern "C" int arachne_enable_peer_access(int device, int peer)
{
    if (device == peer) return 0;
    int can = 0;
    cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
    if (e != cudaSuccess) return (int)e;
    if (!can) return (int)cudaErrorPeerAccessUnsupported;
    int prev = 0;
    e = cudaGetDevice(&prev);
    if (e == cudaSuccess) e = cudaSetDevice(device);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();   // not sticky: clear it, or the next launch would report it
        e = cudaSuccess;
    }
    const cudaError_t back = cudaSetDevice(prev);
    return (int)(e != cudaSuccess ? e : back);
}

// cudaDeviceGetLimit(cudaLimitMaxL2FetchGranularity) of the current device
// into *bytes: how many bytes the L2 fetches from HBM for a sector missed.
extern "C" int arachne_l2_fetch_granularity(long long* bytes)
{
    size_t v = 0;
    const cudaError_t e = cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity);
    *bytes = (long long)v;
    return (int)e;
}
