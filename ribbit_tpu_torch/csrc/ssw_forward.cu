// SSW forward scoring of device-batched refinement, written for Hopper
// (sm_90a).
//
// Replaces three TPU kernels that compute one function:
//   ribbit_tpu/align_pallas_v3.py:35 _fwd_kernel (K3, one pair a lane, the
//     pairs within fits()) and ribbit_tpu/align_pallas_v2.py:49 (K9, K3
//     without row blocks): ribbit_ssw_forward_small;
//   ribbit_tpu/align_pallas.py:59 _fwd_kernel (K4, reads on lanes, any
//     length): ribbit_ssw_forward_large.
// For each (read, ref) pair of codes 0-4 they compute the exact forward pass
// of the reference's local alignment (ribbit_tpu/align.py _forward_pass,
// csrc/ribbit_align.c): per ref column i and read row j,
//
//     diag = min(H[i-1][j-1] + (ref[i] == read[j] < 4 ? 2 : -2), 32767)
//     h0   = max(diag, E[j], 0)
//     F[j] = max(F[j-1] - 1, h0[j-1] - 3, 0)         (lazy F, 0 at j = 0)
//     H[j] = max(h0, F[j])
//     E[j] = max(E[j] - 1, H[j] - 3, 0)
//
// (clamping F at 0 each row gives max(F, 0) of the unclamped chain, and only
// that reaches H) and return four int32 per pair: score (best column max),
// end_ref (the first column that is strictly greater), end_read (the
// smallest row reaching the max in that column) and first_hit (terminate
// mode, term >= 0: the first column whose max equals term; the pass stops
// after it).  Pairs are ragged: codes concatenated, with int64 offsets.
// Output rows are [4][n].
//
// Design: a striped wavefront over each pair's rows.  A group of G lanes
// serves one pair (G = 32, a warp, in the small kernel; G = 32 x
// LARGE_WARPS, a block, in the large one).  Lane k owns the S read rows
// [k S, k S + S) of a band of G S rows, with H and E of its rows in
// registers (S is a template parameter: one instance per strip bucket of
// SSW_STRIPS), and takes COLS ref columns a step: columns
// COLS (t - k) to COLS (t - k) + COLS - 1 at step t (COLS is 1 in the small
// kernel and 2 in the large one, whose steps each end on a barrier).
// After each step lane k hands lane k + 1 its bottom row at those columns:
// H (the next column's diag input), h0 - 3 and F (the lazy F chain) and
// the column max so far with its row, packed as H << 16 | (65534 - band
// row), so that one integer max keeps the smallest row of the greatest
// value.  Within a warp the hand-off is a __shfl_up_sync; between the large
// kernel's warps it goes through a two-slot ring in shared memory, one
// barrier a step.  The last lane with rows sees each column's max in
// column order and keeps score, end_ref, end_read and first_hit; a
// terminate hit stops the whole group at once (a vote, or a shared flag
// read after the step's barrier).  Pairs longer than one band run band
// after band: the last lane of a band writes its bottom row per column to
// scratch (2 x 5 int32 a ref base), and lane 0 of the next band reads it,
// so there is no row cap and no H or E in device memory.  The cell
// arithmetic is Hopper's DPX instructions: add-min for diag, max-relu for
// h0, add-max-relu for the F and E gap steps.  Each strip bucket is a
// launch of its own, and the launches run side by side on streams forked
// from the caller's and joined back to it (the caller owns the streams
// and the two events).
//
// What bounds them on this card: integer operations.  The recurrence needs
// at least 7 fused operations a cell; on 16-bit values (every score is <=
// 32767) the s16x2 forms would take two cells a 32-bit slot, so the bound
// is cells x 3.5 int32 issue slots over the card's issue limit, 128 lanes
// an SM a clock (bench_roofline.ISSUE_LANES_PER_SM), and reads nothing
// from device memory beyond the pairs' codes.  These kernels use one 32-bit
// lane a cell and about 11 operations: the score from a per-column match
// mask (2), diag (1), h0 (1), F (2), H (1), E (2), the packed column max
// (2).  A group's pair runs on one SM, so the batch's largest pair bounds
// its time from below at that pair's cells over one SM's rate.  What holds
// them on the longest pairs (per-warp clock64() spans on an H100): a step's
// fixed work (waiting for the hand-off, the shuffles, the last lane's
// bookkeeping, the large kernel's barrier) took about as long as a
// column's rows, whose instructions issue at about one a clock a warp;
// two columns a step share that work in the large kernel.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

#define GAP_O 3
#define GAP_E 1
#define WORD_MAX 32767
#define FULL_MASK 0xffffffffu
#define SMALL_WARPS 4          // pairs (one a warp) per block, small kernel
#define LARGE_WARPS 8          // warps on one pair, large kernel
#define ARG_IN 0xffff          // row field of a column max from the band above
#define SMALL_COLS 1           // ref columns a lane takes in one step: small
#define LARGE_COLS 2           // and large kernel

struct __align__(16) Carry {   // a strip's bottom row at one column
    int h, h0m3, f, key;
};

// scratch[(buf * 5 + field) * nref + ref position]: a band's bottom row per
// column (H, h0 - 3, F, column max, its row), double-buffered by band
__device__ __forceinline__ int *field_of(int32_t *scratch, int buf, int fld,
                                         int nref, int64_t pos)
{
    return scratch + (size_t)(buf * 5 + fld) * nref + pos;
}

__device__ __forceinline__ uint32_t match_mask(int rc, uint32_t m0,
                                               uint32_t m1, uint32_t m2,
                                               uint32_t m3)
{
    return rc == 0 ? m0 : rc == 1 ? m1 : rc == 2 ? m2 : rc == 3 ? m3 : 0u;
}

// One ref column down a lane's strip: H and E in place, the row above's
// bottom x in, the strip's bottom out.  hd is H of the row above at the
// previous column (the first row's diag); m has bit j set where row j
// matches the column's base.
template <int S>
__device__ __forceinline__ Carry strip_column(int (&H)[S], int (&E)[S],
                                              const int (&cj)[S], uint32_t m,
                                              int hd, Carry x)
{
    int f = x.f, h0m3 = x.h0m3, key = x.key;
#pragma unroll
    for (int j = 0; j < S; j++) {
        const int sc = (int)((m >> j) & 1u) * 4 - 2;
        const int diag = __viaddmin_s32(hd, sc, WORD_MAX);
        hd = H[j];
        const int h0 = __vimax_s32_relu(diag, E[j]);
        f = __viaddmax_s32_relu(f, -GAP_E, h0m3);
        const int hn = max(h0, f);
        E[j] = __viaddmax_s32_relu(E[j], -GAP_E, hn - GAP_O);
        H[j] = hn;
        key = max(key, hn * 65536 + cj[j]);
        h0m3 = h0 - GAP_O;
    }
    return Carry{H[S - 1], h0m3, f, key};
}

template <int W, int S, int COLS>
__global__ void __launch_bounds__(W == 1 ? 32 * SMALL_WARPS : 32 * W)
ssw_strip_kernel(const uint8_t *__restrict__ read,
                 const int64_t *__restrict__ read_off,
                 const uint8_t *__restrict__ ref,
                 const int64_t *__restrict__ ref_off,
                 const int32_t *__restrict__ term,
                 const int32_t *__restrict__ order, int count, int nref,
                 int32_t *scratch, int32_t *__restrict__ out, int n)
{
    constexpr int G = 32 * W;                  // lanes on one pair
    __shared__ Carry ring[2][W][COLS];
    __shared__ int s_stop;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int slot, k;
    if (W == 1) {
        slot = blockIdx.x * SMALL_WARPS + warp;
        k = lane;
        if (slot >= count)
            return;                            // the whole warp
    } else {
        slot = blockIdx.x;
        k = threadIdx.x;
        if (k == 0)
            s_stop = 0;
        __syncthreads();
    }
    const int p = order[slot];
    const int64_t r0 = read_off[p], c0 = ref_off[p];
    const int R = (int)(read_off[p + 1] - r0);
    const int C = (int)(ref_off[p + 1] - c0);
    const int tm = term[p];
    const int nbands = R > G * S ? (R + G * S - 1) / (G * S) : 1;

    int best = 0, end_ref = -1, end_read = -1, first_hit = -1;
    for (int b = 0; b < nbands; b++) {
        const int row0 = b * G * S;
        const int rows = min(R - row0, G * S);
        const int last = rows > S ? (rows + S - 1) / S - 1 : 0;
        const bool final_band = b == nbands - 1;
        const int in = b & 1, outb = in ^ 1;

        // my strip: match masks of the four bases, H, E and each row's
        // key field (INT_MIN past R: such a row never holds a column max)
        uint32_t m0 = 0, m1 = 0, m2 = 0, m3 = 0;
        int H[S], E[S], cj[S];
#pragma unroll
        for (int j = 0; j < S; j++) {
            const int jl = k * S + j, row = row0 + jl;
            const bool valid = k <= last && jl < rows;
            const int code = valid ? read[r0 + row] : 4;
            m0 |= (uint32_t)(code == 0) << j;
            m1 |= (uint32_t)(code == 1) << j;
            m2 |= (uint32_t)(code == 2) << j;
            m3 |= (uint32_t)(code == 3) << j;
            H[j] = 0;
            E[j] = 0;
            cj[j] = valid ? (ARG_IN - 1) - jl : INT_MIN;
        }

        // step t: my columns COLS (t - k) + q, q < COLS
        int hprev = 0;            // H above my strip at the previous column
        Carry got[COLS];
        int rc_next[COLS];
#pragma unroll
        for (int q = 0; q < COLS; q++) {
            got[q] = Carry{0, -GAP_O, 0, 0};
            rc_next[q] = (k == 0 && q < C) ? ref[c0 + q] : 4;
        }
        const int steps = (C + COLS - 1) / COLS + last;
        for (int t = 0; t < steps; t++) {
            const int cbase = (t - k) * COLS;
            int rc[COLS];
            Carry x[COLS], o[COLS];
#pragma unroll
            for (int q = 0; q < COLS; q++) {
                const int c = cbase + q, cn = c + COLS;
                rc[q] = rc_next[q];
                if (cn >= 0 && cn < C)         // the next step's column
                    rc_next[q] = ref[c0 + cn];
                x[q] = got[q];
                if (k == 0) {
                    x[q] = Carry{0, -GAP_O, 0, 0};
                    if (b > 0 && c >= 0 && c < C) {
                        x[q].h = *field_of(scratch, in, 0, nref, c0 + c);
                        x[q].h0m3 = *field_of(scratch, in, 1, nref, c0 + c);
                        x[q].f = *field_of(scratch, in, 2, nref, c0 + c);
                        x[q].key = (*field_of(scratch, in, 3, nref, c0 + c)
                                    << 16) | ARG_IN;
                    }
                } else if (W > 1 && lane == 0) {
                    x[q] = ring[(t - 1) & 1][warp - 1][q];
                }
                o[q] = x[q];
                if (k <= last && c >= 0 && c < C) {
                    o[q] = strip_column<S>(
                        H, E, cj, match_mask(rc[q], m0, m1, m2, m3), hprev,
                        x[q]);
                    hprev = x[q].h;
                }
            }
#pragma unroll
            for (int q = 0; q < COLS; q++) {
                got[q].h = __shfl_up_sync(FULL_MASK, o[q].h, 1);
                got[q].h0m3 = __shfl_up_sync(FULL_MASK, o[q].h0m3, 1);
                got[q].f = __shfl_up_sync(FULL_MASK, o[q].f, 1);
                got[q].key = __shfl_up_sync(FULL_MASK, o[q].key, 1);
                if (W > 1 && lane == 31)
                    ring[t & 1][warp][q] = o[q];
            }
            // the last lane's bookkeeping, as selects on every lane: a
            // branch would hold the warp on that one lane each step
            bool stop = false;
#pragma unroll
            for (int q = 0; q < COLS; q++) {
                const int c = cbase + q;
                const bool mine = k == last && c >= 0 && c < C && !stop;
                const int cm = o[q].key >> 16, fld = o[q].key & 0xffff;
                int row = row0 + (ARG_IN - 1) - fld;
                if (b > 0 && mine && fld == ARG_IN)
                    row = *field_of(scratch, in, 4, nref, c0 + c);
                if (!final_band) {
                    if (mine) {
                        *field_of(scratch, outb, 0, nref, c0 + c) = o[q].h;
                        *field_of(scratch, outb, 1, nref, c0 + c) = o[q].h0m3;
                        *field_of(scratch, outb, 2, nref, c0 + c) = o[q].f;
                        *field_of(scratch, outb, 3, nref, c0 + c) = cm;
                        *field_of(scratch, outb, 4, nref, c0 + c) = row;
                    }
                } else {
                    const bool better = mine && cm > best;  // first column
                    best = better ? cm : best;
                    end_ref = better ? c : end_ref;
                    end_read = better ? row : end_read;
                    const bool hit = mine && tm >= 0 && cm == tm;
                    first_hit = hit ? c : first_hit;    // and it breaks
                    stop = stop || hit;
                }
            }
            if (W > 1) {
                if (stop)
                    s_stop = 1;
                __syncthreads();
                if (s_stop)
                    break;
            } else if (__any_sync(FULL_MASK, stop)) {
                break;
            }
        }
        // the band's scratch rows reach the next band's lane 0
        if (W > 1)
            __syncthreads();
        else
            __syncwarp();
        if (final_band && k == last) {
            out[p] = best;
            out[n + p] = end_ref;
            out[2 * n + p] = end_read;
            out[3 * n + p] = first_hit;
        }
    }
}

// Rows a lane holds in registers: one kernel instance per strip bucket, in
// the order the host plans and launches them (align_kernels.launch_plan
// reads this table through ribbit_ssw_strips)
#define SSW_STRIPS 32, 20, 12, 8, 4, 1
static const int32_t g_strips[] = {SSW_STRIPS};
static constexpr int NSTRIPS = sizeof g_strips / sizeof g_strips[0];

// f(std::integral_constant<int, S>) for the S of the pack equal to strip
template <int... S, class F>
static void with_strip(int strip, F &&f)
{
    ((strip == S && (f(std::integral_constant<int, S>{}), true)) || ...);
}

// counts[i] pairs of strip bucket i lie in `order` bucket after bucket.
// Bucket i runs on sides[i], forked from `stream` (through the event fork)
// and joined back to it (through join): a bucket's time is its longest
// pair's walk, so in turn they would add up.
template <int W, int COLS>
static int launch(const uint8_t *read, const int64_t *read_off,
                  const uint8_t *ref, const int64_t *ref_off,
                  const int32_t *term, const int32_t *order,
                  const int32_t *counts, int n, int nref, int32_t *scratch,
                  int32_t *out, int device, cudaStream_t stream,
                  const cudaStream_t *sides, cudaEvent_t fork,
                  cudaEvent_t join)
{
    cudaError_t err = cudaSetDevice(device);
    if (err == cudaSuccess)
        err = cudaEventRecord(fork, stream);
    const int threads = W == 1 ? 32 * SMALL_WARPS : 32 * W;
    int start = 0;
    for (int i = 0; i < NSTRIPS && err == cudaSuccess; i++) {
        const int cnt = counts[i];
        if (cnt <= 0)
            continue;
        const int grid = W == 1 ? (cnt + SMALL_WARPS - 1) / SMALL_WARPS : cnt;
        const int32_t *ord = order + start;
        cudaStream_t side = sides[i];
        err = cudaStreamWaitEvent(side, fork, 0);
        if (err != cudaSuccess)
            break;
        with_strip<SSW_STRIPS>(g_strips[i], [&](auto s) {
            ssw_strip_kernel<W, decltype(s)::value, COLS>
                <<<grid, threads, 0, side>>>(read, read_off, ref, ref_off,
                                             term, ord, cnt, nref, scratch,
                                             out, n);
        });
        err = cudaGetLastError();
        if (err == cudaSuccess)   // a wait takes the event's latest record
            err = cudaEventRecord(join, side);
        if (err == cudaSuccess)
            err = cudaStreamWaitEvent(stream, join, 0);
        start += cnt;
    }
    return err != cudaSuccess ? (int)err : start == n ? 0 : -1;
}

// The strip table: sets *table and returns its length.
extern "C" int ribbit_ssw_strips(const int32_t **table)
{
    *table = g_strips;
    return NSTRIPS;
}

// All pointers but counts and sides (host arrays, one entry per strip of
// the table) are device pointers on `device`, and so are the streams and
// the two events; the launches are ordered after `stream`'s earlier work
// and `stream` after them, and nothing synchronises with the host.  Returns the first CUDA error, -1 if the
// counts do not add up to n, else 0.
extern "C" int ribbit_ssw_forward_small(
    const uint8_t *read, const int64_t *read_off, const uint8_t *ref,
    const int64_t *ref_off, const int32_t *term, const int32_t *order,
    const int32_t *counts, int n, int nref, int32_t *scratch, int32_t *out,
    int device, cudaStream_t stream, const cudaStream_t *sides,
    cudaEvent_t fork, cudaEvent_t join)
{
    return launch<1, SMALL_COLS>(read, read_off, ref, ref_off, term, order,
                                 counts, n, nref, scratch, out, device,
                                 stream, sides, fork, join);
}

extern "C" int ribbit_ssw_forward_large(
    const uint8_t *read, const int64_t *read_off, const uint8_t *ref,
    const int64_t *ref_off, const int32_t *term, const int32_t *order,
    const int32_t *counts, int n, int nref, int32_t *scratch, int32_t *out,
    int device, cudaStream_t stream, const cudaStream_t *sides,
    cudaEvent_t fork, cudaEvent_t join)
{
    return launch<LARGE_WARPS, LARGE_COLS>(read, read_off, ref, ref_off,
                                           term, order, counts, n, nref,
                                           scratch, out, device, stream,
                                           sides, fork, join);
}
