// BM25 batch scoring: the dense per-query score rows whose top-k K1 takes.
//
// Replaces comet_tpu/indexes/bm25.py:_bm25_device_kernel, the reference's
// XLA scorer (no Pallas kernel): [Q, MC, 512] posting-chunk gathers, the
// BM25 contribution, a scatter-add into [Q, n_pad] float32, the allowed
// mask and lax.top_k. Here the top-k is K1 (csrc/topk.cu) on the negated
// rows this kernel writes, which gives lax.top_k's order: score desc, then
// slot asc (slots are documents in ascending id order).
//
// For query q (one block) and every posting (slot, tf) of each of its
// terms t, in the query's token order, repeats included (t's float32 idf
// given):
//   c = idf * (tf * (K1 + 1)) / (tf + K1 * ((1 - B) + B * (dl / avgdl)))
//   row[slot] += c
// in exactly that operation order, each step rounded alone (__fmul_rn,
// __fadd_rn, __fdiv_rn, so nvcc contracts nothing into an FMA): the XLA
// expression of the reference (bm25.py:619-621), bit-equal to the plain
// version in ops/bm25.py. A term's postings have distinct slots, so the
// block's threads stride over them without two of them touching one
// score; a __syncthreads() between terms makes every document's sum run
// in term order, the reference's order (its C loop and XLA scatter add a
// document's contributions term by term). CUDA's atomic scatter-add
// (index_add_, scatter_add_) adds them in an order that changes from run
// to run, so scores would differ in their last bits and tied ids swap.
// Then row[i] = allowed[i] ? -row[i] : 0 over the whole row: a masked or
// untouched document scores 0, which the wrapper reads as missing.
//
// What bounds it on an H100: bytes. A posting reads 8 bytes (slot, tf),
// gathers its document length (4) and reads and writes its score (8); the
// row is zeroed, then read and written once by the mask (12 bytes a slot),
// and K1 reads it again. With the default segmentation every multi-word
// query also scores the whitespace term, which covers about every
// document: a 2-term query over 2^20 documents moves about 34 MB here
// (22 MB of postings, lengths and scores, 12 MB of the row), 10 us at
// 3.35 TB/s. The whitespace posting's slots ascend one by one, so its
// score traffic is coalesced. The design is the simple one: one block a
// query, every access strided by the block, nothing staged in shared
// memory.

#include <cuda_runtime.h>

constexpr int BM25_THREADS = 512;
constexpr float BM25_K1 = 1.2f;
constexpr float BM25_K1P1 = 2.2f;   // K1 + 1, rounded once as the reference's float32 constant
constexpr float BM25_B = 0.75f;
constexpr float BM25_1MB = 0.25f;   // 1 - B

__global__ void __launch_bounds__(BM25_THREADS) bm25_score_kernel(
    const int* __restrict__ post_slot, const float* __restrict__ post_tf,
    const long long* __restrict__ t_start, const int* __restrict__ t_len,
    const float* __restrict__ t_idf, const int* __restrict__ q_off,
    const float* __restrict__ doc_len, const unsigned char* __restrict__ allowed,
    long long n_pad, float avgdl, float* __restrict__ out)
{
    const int q = blockIdx.x;
    float* row = out + (long long)q * n_pad;
    for (long long i = threadIdx.x; i < n_pad; i += BM25_THREADS) row[i] = 0.0f;
    __syncthreads();
    const int t_end = q_off[q + 1];
    for (int t = q_off[q]; t < t_end; ++t) {
        const long long s0 = t_start[t];
        const int n = t_len[t];
        const float idf = t_idf[t];
        for (int j = threadIdx.x; j < n; j += BM25_THREADS) {
            const int slot = post_slot[s0 + j];
            const float tf = post_tf[s0 + j];
            const float norm = __fadd_rn(BM25_1MB, __fmul_rn(BM25_B, __fdiv_rn(doc_len[slot], avgdl)));
            const float den = __fadd_rn(tf, __fmul_rn(BM25_K1, norm));
            const float c = __fdiv_rn(__fmul_rn(idf, __fmul_rn(tf, BM25_K1P1)), den);
            row[slot] = __fadd_rn(row[slot], c);
        }
        __syncthreads();
    }
    for (long long i = threadIdx.x; i < n_pad; i += BM25_THREADS)
        row[i] = allowed[i] ? -row[i] : 0.0f;
}

// post_slot [P] i32 and post_tf [P] f32: every term's postings, one run a
// term (CSR); t_start [M] i64, t_len [M] i32, t_idf [M] f32: the terms of
// the Q queries, query-major; q_off [Q + 1] i32: query q's terms are
// [q_off[q], q_off[q + 1]) (absolute into the term arrays); doc_len and
// allowed [n_pad]; out [Q, n_pad] f32.
extern "C" int comet_bm25_score(
    const int* post_slot, const float* post_tf, const long long* t_start, const int* t_len,
    const float* t_idf, const int* q_off, int Q, const float* doc_len,
    const unsigned char* allowed, long long n_pad, float avgdl, float* out, void* stream)
{
    if (Q < 1 || n_pad < 1) return (int)cudaErrorInvalidValue;
    bm25_score_kernel<<<Q, BM25_THREADS, 0, (cudaStream_t)stream>>>(
        post_slot, post_tf, t_start, t_len, t_idf, q_off, doc_len, allowed, n_pad, avgdl, out);
    return (int)cudaGetLastError();
}
