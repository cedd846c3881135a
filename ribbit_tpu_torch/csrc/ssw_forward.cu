// SSW forward scoring of device-batched refinement, written for Hopper
// (sm_90a).
//
// Both kernels compute, for each (read, ref) pair of codes 0-4, the exact
// forward pass of the reference's local alignment (ribbit_tpu/align.py
// _forward_pass, csrc/ribbit_align.c): per ref column i and read row j,
//
//     diag = min(H[i-1][j-1] + (ref[i] == read[j] < 4 ? 2 : -2), 32767)
//     h0   = max(diag, E[j], 0)
//     F[j] = max(F[j-1] - 1, h0[j-1] - 3)            (lazy F, 0 at j = 0)
//     H[j] = max(h0, F[j], 0)
//     E[j] = max(E[j] - 1, H[j] - 3, 0)
//
// and returns four int32 per pair: score (best column max), end_ref (the
// first column that is strictly greater), end_read (the smallest row
// reaching the max in that column) and first_hit (terminate mode, term >=
// 0: the first column whose max equals term; the pass stops after it).
// Pairs are ragged: read and ref codes concatenated, with int64 offsets;
// nothing is padded to the batch maximum.  Output rows are [4][n].
//
// ssw_forward_small_kernel (replaces align_pallas_v3._fwd_kernel,
//   ribbit_tpu/align_pallas_v3.py:35) takes K3's mapping: one thread per
//   pair, columns outer and rows inner, carrying h_old[j-1], h0[j-1], f,
//   the column max and its row.  H, E and the read live in scratch laid
//   out [row][thread], so the 32 threads of a warp touch 32 neighbouring
//   words.  Threads take pairs in the order given (the wrapper sorts by
//   cells, largest first) so that a warp's pairs are alike in size.
//
// ssw_forward_large_kernel (replaces align_pallas._fwd_kernel,
//   ribbit_tpu/align_pallas.py:59) takes K4's mapping: one block per pair,
//   read rows across the block's threads in tiles of LARGE_THREADS.  Per
//   column F comes from a block-wide inclusive prefix max of h0[j] + j
//   (F[j] = max(P[j-1] - 3 - (j-1), 0), K4's formula); the column max and
//   its smallest row come from one 64-bit max of (H << 32 | ~j).  H and E
//   live in dynamic shared memory where the pair's 8 * R bytes fit
//   (smem_rows), otherwise in global scratch at the pair's read offset.
//   There is no row cap.
//
// What bounds them on this card: integer operations.  The recurrence needs
// at least 7 fused operations a cell (DPX add-min for diag, max3 for h0, H
// and E, add-max for the F and E gap steps, a max for the column) and
// reads nothing from device memory beyond the pair's codes; on 16-bit
// values (every score is <= 32767) the s16x2 forms take two cells a 32-bit
// slot, so the bound is cells x 3.5 over the SMs' int32 rate (132 SMs x 64
// lanes x clock).  These kernels spend more: about 19 int32 operations a
// cell in the inner loop (the score select, the column max and its row
// each cell), one 32-bit lane per cell, no striping, no anti-diagonal
// wavefronts.  The small kernel moves 17 B of scratch a cell (H, E and the
// read, [row][thread]); where those accesses are served from (L1, L2 or
// HBM) was not measured.

#include <cuda_runtime.h>
#include <stdint.h>

#define GAP_O 3
#define GAP_E 1
#define WORD_MAX 32767
#define NEG (-(1 << 24))
#define SMALL_THREADS 128
#define LARGE_THREADS 256
#define LARGE_WARPS (LARGE_THREADS / 32)
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ long long kmax(long long a, long long b)
{
    return a > b ? a : b;
}

__global__ void __launch_bounds__(SMALL_THREADS)
ssw_forward_small_kernel(const uint8_t *__restrict__ read,
                         const int64_t *__restrict__ read_off,
                         const uint8_t *__restrict__ ref,
                         const int64_t *__restrict__ ref_off,
                         const int32_t *__restrict__ term,
                         const int32_t *__restrict__ order, int n,
                         int32_t *__restrict__ H, int32_t *__restrict__ E,
                         uint8_t *__restrict__ rd, int32_t *__restrict__ out)
{
    const int t = blockIdx.x * SMALL_THREADS + threadIdx.x;
    if (t >= n)
        return;
    const int p = order[t];
    const int64_t r0 = read_off[p], c0 = ref_off[p];
    const int R = (int)(read_off[p + 1] - r0);
    const int C = (int)(ref_off[p + 1] - c0);
    const int tm = term[p];

    for (int j = 0; j < R; j++) {
        const size_t k = (size_t)j * n + t;
        H[k] = 0;
        E[k] = 0;
        rd[k] = read[r0 + j];
    }
    int best = 0, end_ref = -1, end_read = -1, first_hit = -1;
    for (int i = 0; i < C; i++) {
        const int rc = ref[c0 + i];
        const bool base = rc < 4;
        int h_jm1 = 0, h0_prev = NEG, f = NEG, colmax = 0, argj = -1;
        size_t k = t;
        for (int j = 0; j < R; j++, k += n) {
            const int h_j = H[k], e_j = E[k];
            f = max(f - GAP_E, h0_prev - GAP_O);
            const int sc = (base && rc == rd[k]) ? 2 : -2;
            const int diag = min(h_jm1 + sc, WORD_MAX);
            const int h0 = max(max(diag, e_j), 0);
            const int hn = max(h0, max(f, 0));
            H[k] = hn;
            E[k] = max(max(e_j - GAP_E, hn - GAP_O), 0);
            if (hn > colmax) {             // strictly greater: smallest row
                colmax = hn;
                argj = j;
            }
            h_jm1 = h_j;
            h0_prev = h0;
        }
        if (colmax > best) {
            best = colmax;
            end_ref = i;
            end_read = argj;
        }
        if (tm >= 0 && colmax == tm) {     // the reference breaks after it
            first_hit = i;
            break;
        }
    }
    out[p] = best;
    out[n + p] = end_ref;
    out[2 * n + p] = end_read;
    out[3 * n + p] = first_hit;
}

// Shared-memory hazards: a tile's threads read H[j-1], H[j], E[j] before the
// scan's barrier and write H[j], E[j] after it.  Row j-1 of a tile's first
// thread belongs to the previous tile, already overwritten, so its old value
// travels in s_carry; s_carry, s_wt and s_red are double-buffered by tile
// (or column) parity, so one barrier a tile and one a column suffice.
__global__ void __launch_bounds__(LARGE_THREADS)
ssw_forward_large_kernel(const uint8_t *__restrict__ read,
                         const int64_t *__restrict__ read_off,
                         const uint8_t *__restrict__ ref,
                         const int64_t *__restrict__ ref_off,
                         const int32_t *__restrict__ term,
                         const int32_t *__restrict__ order, int smem_rows,
                         int32_t *Hg, int32_t *Eg, int32_t *__restrict__ out,
                         int n)
{
    extern __shared__ int32_t sm[];
    __shared__ int32_t s_wt[2][LARGE_WARPS];
    __shared__ int32_t s_carry[2];
    __shared__ long long s_red[2][LARGE_WARPS];

    const int p = order[blockIdx.x];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t r0 = read_off[p], c0 = ref_off[p];
    const int R = (int)(read_off[p + 1] - r0);
    const int C = (int)(ref_off[p + 1] - c0);
    const int tm = term[p];
    const uint8_t *rd = read + r0;
    int32_t *H, *E;
    if (R <= smem_rows) {
        H = sm;
        E = sm + R;
    } else {
        H = Hg + r0;
        E = Eg + r0;
    }
    for (int j = tid; j < R; j += LARGE_THREADS) {
        H[j] = 0;
        E[j] = 0;
    }
    __syncthreads();

    const int ntiles = (R + LARGE_THREADS - 1) / LARGE_THREADS;
    int best = 0, end_ref = -1, end_read = -1, first_hit = -1;
    int par = 0;
    for (int i = 0; i < C; i++) {
        const int rc = ref[c0 + i];
        const bool base = rc < 4;
        int run = NEG;                 // max of h0[k] + k over earlier tiles
        long long key = 0;             // this thread's (H << 32 | ~j) max
        for (int tile = 0; tile < ntiles; tile++) {
            const int j = tile * LARGE_THREADS + tid;
            const bool valid = j < R;
            int h_j = 0, e_j = 0, h_jm1 = 0, code = 4;
            if (valid) {
                h_j = H[j];
                e_j = E[j];
                code = rd[j];
                if (j > 0)
                    h_jm1 = tid == 0 ? s_carry[par] : H[j - 1];
            }
            if (tid == LARGE_THREADS - 1)
                s_carry[par ^ 1] = h_j;
            const int sc = (base && rc == code) ? 2 : -2;
            const int diag = min(h_jm1 + sc, WORD_MAX);
            const int h0 = max(max(diag, e_j), 0);

            // block-wide prefix max of h0[j] + j: warp scan, then the
            // warps' totals through shared memory
            int x = valid ? h0 + j : NEG;
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
                const int y = __shfl_up_sync(FULL_MASK, x, o);
                if (lane >= o)
                    x = max(x, y);
            }
            int before = __shfl_up_sync(FULL_MASK, x, 1);
            if (lane == 0)
                before = NEG;
            if (lane == 31)
                s_wt[par][warp] = x;
            __syncthreads();
            int total = NEG;
#pragma unroll
            for (int w = 0; w < LARGE_WARPS; w++) {
                const int v = s_wt[par][w];
                if (w < warp)
                    before = max(before, v);
                total = max(total, v);
            }
            before = max(before, run);       // max over rows k < j
            run = max(run, total);

            const int F = j == 0 ? 0
                                 : max(before - GAP_O - (j - 1) * GAP_E, 0);
            const int hn = max(h0, F);
            if (valid) {
                H[j] = hn;
                E[j] = max(max(e_j - GAP_E, hn - GAP_O), 0);
                key = kmax(key, ((long long)hn << 32)
                                    | (long long)(0x7fffffff - j));
            }
            par ^= 1;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            key = kmax(key, __shfl_xor_sync(FULL_MASK, key, o));
        if (lane == 0)
            s_red[i & 1][warp] = key;
        __syncthreads();
        long long m = 0;
#pragma unroll
        for (int w = 0; w < LARGE_WARPS; w++)
            m = kmax(m, s_red[i & 1][w]);
        const int colmax = (int)(m >> 32);
        if (colmax > best) {
            best = colmax;
            end_ref = i;
            end_read = 0x7fffffff - (int)(m & 0xffffffff);
        }
        if (tm >= 0 && colmax == tm) {       // uniform across the block
            first_hit = i;
            break;
        }
    }
    if (tid == 0) {
        out[p] = best;
        out[n + p] = end_ref;
        out[2 * n + p] = end_read;
        out[3 * n + p] = first_hit;
    }
}

// All pointers are device pointers on `device`; the launch goes onto
// `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int ribbit_ssw_forward_small(
    const uint8_t *read, const int64_t *read_off, const uint8_t *ref,
    const int64_t *ref_off, const int32_t *term, const int32_t *order, int n,
    int32_t *H, int32_t *E, uint8_t *rd, int32_t *out, int device,
    cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int grid = (n + SMALL_THREADS - 1) / SMALL_THREADS;
    ssw_forward_small_kernel<<<grid, SMALL_THREADS, 0, stream>>>(
        read, read_off, ref, ref_off, term, order, n, H, E, rd, out);
    return (int)cudaGetLastError();
}

extern "C" int ribbit_ssw_forward_large(
    const uint8_t *read, const int64_t *read_off, const uint8_t *ref,
    const int64_t *ref_off, const int32_t *term, const int32_t *order, int n,
    int smem_rows, int32_t *Hg, int32_t *Eg, int32_t *out, int device,
    cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const size_t smem = (size_t)smem_rows * 2 * sizeof(int32_t);
    if (smem > 48 * 1024) {
        err = cudaFuncSetAttribute((const void *)ssw_forward_large_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess)
            return (int)err;
    }
    ssw_forward_large_kernel<<<n, LARGE_THREADS, smem, stream>>>(
        read, read_off, ref, ref_off, term, order, smem_rows, Hg, Eg, out,
        n);
    return (int)cudaGetLastError();
}
