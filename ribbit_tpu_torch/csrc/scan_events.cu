// Device event extraction for the shift-XOR scan, written for Hopper (sm_90a).
//
// Two kernels replace the two Pallas passes of
// ribbit_tpu/scan_events_pallas.py.  Both compute, per shift row r
// (shift s = min_shift + r, r < ns), the match bitmap
//
//     eq[r][p] = code[p] == code[p + s]      for 0 <= p < L,
//
// where code reads as 0 past L (the reference's zero-fill tail, and N
// bases encode as 0 too).  Positions p < 0 never match.
//
// anchor_planes_kernel (replaces _anchor_kernel, scan_events_pallas.py:95)
//   An anchor is a maximal run of eq restricted to p < L - s whose length
//   lies in [3, 2s) and which closes strictly before L - s
//   (parse_anchored_shiftxor.cpp:20-56).  Output: one bit-word per 32
//   positions per shift row, [ns, ceil(L/32)] (4 B per 32 bp per row,
//   13 B/bp at the default config).  The planes never leave the device.
//
// event_words_kernel (replaces _kernel, scan_events_pallas.py:187)
//   For the 8 rows of one output plane: the overlay ov = eq | anchors of
//   rows r-2, r-1, r+1, r+2 (those in [0, ns)), and three bitmaps
//     q6 = popcount(ov[p..p+7]) >= 6 and no N in n_mask[p..p+7]
//     q7 = popcount(eq[p..p+7]) >= 7 and no N in n_mask[p..p+7]
//     pm = eq[p] and not N[p]
//   where positions >= L count as N.  Output word layout (fixed; read by
//   csrc/ribbit_events.c): bits 0-7 q6, 8-15 q7, 16-23 pm, one int32 per
//   position per plane, [ngroups, L].
//   It also stores, in ov_out, the overlay of every motif row
//   (shift m in [min_motif, max_motif], channel d = m - min_motif) packed,
//   bit j of word w = position 32 w + j, OW = 2 ceil(L / 64) words a row
//   and bits from L on 0: on a little-endian host a row is the C core's
//   packed overlay cache row (ov_pack, csrc/ribbit_core.c) as it stands.
//
// dense_masks_kernel (replaces _kernel, scan_pallas_v4.py:70, and
//   _gen_kernel_body, scan_pallas_full.py:78, which compute the same planes)
//   For motif rows k (shift row r = r0 + k, shift = motif m = min_shift + r)
//   four int8 planes [nm, L]: q7 and q6 as above, pm = eq & ~N, and
//     ps[p] = pm[p] & ~pm[p-1] & (the pm run from p is >= cutoff),
//   cutoff = 12 - m if m <= 6 else m, pm[-1] = 0.  The run length is exact
//   (the Pallas kernels saturate it at 128 and 256; every cutoff up to 128
//   gives the same planes).  Output: [4][nm][L], planes q7, q6, ps, pm.
//
// What bounds them on this card: the event pass writes 52 B/bp (13 planes
// x 4 B) and that plane then crosses PCIe to the host, plus 12.4 B/bp of
// packed overlay (a bit per motif row), so the output bytes bound the pass
// (0.167 ms at an 8 Mi-bp segment without the overlay); compute is about ns x
// (an 8-bit window popcount twice, four neighbour ORs) integer ops per bp.
// The dense pass writes 4 B per motif row per bp (396 B/bp at the default
// config) against 14.75 B/bp read, so it too is bound by its output bytes.
// The anchor pass writes 12.75 B/bp (0.032 ms at the segment), but its
// run test issues over a hundred instructions per word and row, so the
// instruction issue, not its bytes, sets its pace (PERF.md).  Each pass
// keeps every per-position quantity as a bit in a 32-bit word.
//
// The dense pass takes a tile of 256 words (8,192 positions) of every motif
// row in one block, so the code is read once.  The block builds the code's
// bit-planes and N words over the tile and a thin halo once (plane_words);
// a thread then owns one word of each row, row after row with no barrier:
// eq of three words by funnel shifts (eq_planes), the overlay from anchor
// rows held in a rolling window of registers, q7 and q6 by the event pass's
// bit-sliced counters (few_zeros), the perfect-run starts bit-parallel (an
// AND of log-doubled shifts for cutoffs up to 32, __clz and a walk past
// all-ones words beyond), and each plane word turns into 32 bytes by a
// nibble multiply and leaves in two 16-byte streaming stores.  Lanes trade
// halves of their words by __shfl_sync so that each store instruction of a
// warp writes 512 contiguous bytes of a row: with each lane writing its own
// 32 bytes (two stores 32 bytes apart) the kernel ran 1.8x slower on an
// H100, for the same bytes (PERF.md).
//
// The anchor pass takes a tile of 512 words (16,384 positions) of every
// shift row in one block.  The block builds the code's two bit-planes over
// the tile and K + 1 words on each side (K = ceil(2 s_max / 32); 8 words,
// 3% of the tile, at the default config) once by __ballot_sync
// (plane_words, below); a run that reaches K words past a word is at least
// 2s long and never an anchor.  A thread then owns one word of each row,
// row after row with no barrier: the eq word of its word (two funnel
// shifts over the planes, eq_planes, masked before position 0 and from
// L - s on), its neighbours' from the lanes beside it by __shfl_sync
// (lanes 0 and 31 build the word past the warp's edge), the runs through
// bit 0 and bit 31 measured by __clz of the neighbours (walking on, eq word
// by eq word, only past a neighbour of all ones), the runs inside the word
// tested bit-parallel, and consecutive threads store consecutive words of
// a row.
//
// The event pass works on 32 positions at once, so that its integer work
// falls towards its 52 B/bp of stores.  A block builds the code's two
// bit-planes and the N words of its tile once by __ballot_sync (codes are
// 0-3, N reads as 0, so equal codes <=> equal bits in both planes) and
// reuses them for every plane; a thread then takes one word (32 positions)
// of each plane: eq of shift s is ~((lo ^ lo>>s) | (hi ^ hi>>s)), two funnel
// shifts over words; anchors are read by consecutive threads at consecutive
// words; q6 and q7 of 32 windows come from bit-sliced counters of the zeros
// in the 8 shifted copies of the word; one 32 x 32 bit transpose in
// registers turns the 24 bit-rows (q6, q7, pm of 8 rows) into 32 int32, and
// a staging tile in shared memory lets a warp store each word as 128
// contiguous bytes.  On an H100 that reaches about two thirds of the byte
// bound (PERF.md); a warp-wide version (a lane a bit-row, the transpose by
// __shfl_xor_sync) ran half as fast: half its lanes counted no window.

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;

#define OUT_ROWS 8     // shift rows per output plane in the event pass

#define EV_T 256       // event pass: threads a block = tile words, one each
#define EV_WARPS (EV_T / 32)
#define EV_PU 4        // words a warp has in flight while building the planes
#define AROWS (OUT_ROWS + 4)   // anchor rows one plane's overlay reads

// The code's two bit-planes and the N words over n words from global word
// w0, into shared memory: bit j of lo[i] / hi[i] is bit 0 / 1 of the code
// at position 32 (w0 + i) + j (0 before 0 and past L), bit j of nw[i] says
// N there (1 before 0 and past L).  Codes are 0-3 and N is 0, so two
// positions hold equal codes iff both planes agree there.  Each warp of the
// block takes every nwarps-th word, one position a lane and one
// __ballot_sync per word, PU words in flight; no barrier.  w0 may be
// negative.  Without N words (WITH_N false) nmask and nw are not touched.
template <bool WITH_N, int PU>
__device__ __forceinline__ void plane_words(const uint8_t *__restrict__ code,
                                            const uint8_t *__restrict__ nmask,
                                            int L, int w0, int n, u32 *lo,
                                            u32 *hi, u32 *nw)
{
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    for (int i4 = warp; i4 < n; i4 += PU * nwarps) {
        u32 c[PU];
        bool nb[PU];
#pragma unroll
        for (int u = 0; u < PU; u++) {
            int i = i4 + u * nwarps;
            long long p = (long long)(w0 + i) * 32 + lane;
            bool in = i < n && p >= 0 && p < L;
            c[u] = in ? code[p] : 0u;
            nb[u] = WITH_N && (!in || nmask[p] != 0);
        }
#pragma unroll
        for (int u = 0; u < PU; u++) {
            int i = i4 + u * nwarps;
            u32 b0 = __ballot_sync(0xffffffffu, c[u] & 1u);
            u32 b1 = __ballot_sync(0xffffffffu, c[u] & 2u);
            u32 bn = __ballot_sync(0xffffffffu, nb[u]);
            if (lane == 0 && i < n) {
                lo[i] = b0;
                hi[i] = b1;
                if (WITH_N)
                    nw[i] = bn;
            }
        }
    }
}

// eq bit-word of shift s = 32 q + b at a word whose planes are l and h: la,
// lb (ha, hb) are the planes of words q and q + 1 further on.  Bit j is set
// iff the codes at p and p + s are equal, p the position of bit j.
__device__ __forceinline__ u32 eq_planes(u32 l, u32 h, u32 la, u32 lb,
                                         u32 ha, u32 hb, int b)
{
    return ~((l ^ __funnelshift_r(la, lb, b))
             | (h ^ __funnelshift_r(ha, hb, b)));
}

#define AT 512         // anchor pass: threads a block = tile words, one each
#define APU 16         // anchor pass: code words a warp loads at once

// eq word of shift s = 32 q + b at plane word j (global word gw), masked:
// 0 before position 0 and from hi = L - s on (whi = hi >> 5; hmask, the
// bits of word whi below hi).
__device__ __forceinline__ u32 eq_at(const u32 *lo, const u32 *hi, int j,
                                     int q, int b, int gw, int whi,
                                     u32 hmask)
{
    u32 v = eq_planes(lo[j], hi[j], lo[j + q], lo[j + q + 1], hi[j + q],
                      hi[j + q + 1], b);
    return gw < 0 || gw > whi ? 0u : gw == whi ? v & hmask : v;
}

// Ones that run on past plane word j + step, a word of all ones, in the
// direction step (-1: down from bit 31 of the word below, +1: up from bit
// 0 of the word above, ...): 32 plus their count, or at least cap once the
// count reaches cap.  Rare: only runs of 32 or more come here.
__device__ __noinline__ int ones_beyond(const u32 *lo, const u32 *hi, int j,
                                        int gw, int step, int s, int whi,
                                        u32 hmask, int cap)
{
    const int q = s >> 5, b = s & 31;
    int n = 32;
    for (int k = 2 * step; n < cap; k += step) {
        const u32 x = ~eq_at(lo, hi, j + k, q, b, gw + k, whi, hmask);
        const int c = step < 0 ? __clz(x) : __clz(__brev(x));
        n += c;
        if (c < 32)
            break;
    }
    return n;
}

// Grid: tiles of AT words (32 positions each); a block writes every shift
// row of its tile, a thread one word of each row, row after row with no
// barrier.  Shared memory: the code's two bit-planes over the tile and H =
// K + 1 words on each side (K = ceil(2 s_max / 32)), and the s_max
// positions eq reads past them, built once.  Per row, a thread builds the
// eq word of its word and one more (lane 0 the word below the warp's 32,
// lane 31 the word above, the others a spare), takes its neighbours' from
// the lanes beside it by __shfl_sync and decides its word's anchors:
//   the runs through bit 0 and bit 31 (tmask, lmask; one run if the word
//   is all ones) take their lengths from the ones that run on into the
//   neighbours (cl, cr), which walk further, eq word by eq word, only past
//   a neighbour of all ones, and never past K words (a run that long is
//   at least 2s and no anchor); the runs inside the word are at most 30
//   long and are tested bit-parallel: t marks 3 ones in a row and is
//   dilated back over them, u marks 2s ones in a row (only s <= 15 can
//   have them) and is dilated over them likewise, by log-doubling shifts.
// Consecutive threads store consecutive words of a row.
__global__ void __launch_bounds__(AT) anchor_planes_kernel(
    const uint8_t *__restrict__ code, int L, int min_shift, int ns, int K,
    u32 *__restrict__ out, int W)
{
    extern __shared__ u32 sw[];
    const int s_max = min_shift + ns - 1, H = K + 1;
    const int NP = AT + 2 * H + (s_max >> 5) + 1;   // plane words
    u32 *lo = sw, *hi = lo + NP;

    const int w0 = blockIdx.x * AT, wb = w0 - H;    // wb: word of lo[0]
    plane_words<false, APU>(code, nullptr, L, wb, NP, lo, hi, nullptr);
    __syncthreads();

    const int i = threadIdx.x, lane = i & 31, w = w0 + i, j = H + i;
    const int jx = lane == 0 ? j - 1 : j + 1;       // the extra word
    const u32 L0 = lo[j], H0 = hi[j], LX = lo[jx], HX = hi[jx];
    u32 *o = out + w;
    for (int row = 0; row < ns; row++, o += W) {
        const int s = min_shift + row, q = s >> 5, b = s & 31, n2 = 2 * s;
        const int hpos = L - s, whi = hpos >> 5;
        const int rem = hpos - 32 * min(w, W);     // w >= W: not stored
        const u32 hmask = (1u << (hpos & 31)) - 1u;
        u32 e = eq_planes(L0, H0, lo[j + q], lo[j + q + 1], hi[j + q],
                          hi[j + q + 1], b);
        u32 x = eq_planes(LX, HX, lo[jx + q], lo[jx + q + 1], hi[jx + q],
                          hi[jx + q + 1], b);
        e = w > whi ? 0u : w == whi ? e & hmask : e;
        const int gx = wb + jx;
        x = gx < 0 || gx > whi ? 0u : gx == whi ? x & hmask : x;
        u32 ep = __shfl_up_sync(0xffffffffu, e, 1);
        u32 en = __shfl_down_sync(0xffffffffu, e, 1);
        ep = lane == 0 ? x : ep;
        en = lane == 31 ? x : en;

        int cl = __clz(~ep);                       // ones below bit 0
        int cr = __clz(__brev(~en));               // ones above bit 31
        if (cl == 32)
            cl = ones_beyond(lo, hi, j, w, -1, s, whi, hmask, n2);
        if (cr == 32)
            cr = ones_beyond(lo, hi, j, w, 1, s, whi, hmask, n2);
        const bool full = e == 0xffffffffu;
        const int tc = __clz(__brev(~e)), lc = __clz(~e);   // 32 if full
        const u32 tmask = full ? 0xffffffffu : (1u << tc) - 1u;
        const u32 lmask = full ? 0xffffffffu : ~(0xffffffffu >> lc);
        const u32 in = e & ~tmask & ~lmask;        // runs closed inside
        const u32 t = in & (in >> 1) & (in >> 2);
        u32 a = t | (t << 1) | (t << 2);
        if (n2 <= 30) {                            // uniform in the block
            u32 u = in;
            int k = 1;
            for (; 2 * k <= n2; k *= 2)
                u &= u >> k;
            u &= u >> (n2 - k);                    // bit j: in[j .. j + 2s)
            for (k = 1; 2 * k <= n2; k *= 2)
                u |= u << k;
            u |= u << (n2 - k);
            a &= ~u;
        }
        if (rem > 0 && rem < 32) {                 // the inner run through
            int c = __clz(~(in << (32 - rem)));    // hi - 1 stays open
            a &= ~(((1u << c) - 1u) << (rem - c));
        }
        const int lenl = cl + tc + (full ? cr : 0), endl = full ? 32 + cr : tc;
        const int lenr = lc + cr + (full ? cl : 0);
        if (tc && lenl >= 3 && lenl < n2 && endl < rem)
            a |= tmask;
        if (lc && lenr >= 3 && lenr < n2 && 32 + cr < rem)
            a |= lmask;
        if (w < W)
            *o = a;
    }
}

// Bit j: at most one (one = ~0) or two (one = 0) zeros among bits j..j+7 of
// the 64-bit x1:x0; bit-sliced counters of the zeros, saturating at three.
__device__ __forceinline__ u32 few_zeros(u32 x0, u32 x1, u32 one)
{
    u32 two = 0, three = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
        u32 z = ~__funnelshift_r(x0, x1, j);
        three |= two & z;
        two |= one & z;
        one |= z;
    }
    return ~three;
}

// In-register 32 x 32 bit transpose: afterwards bit b of A[j] is bit j of
// the old A[b].  Each stage swaps the off-diagonal m x m blocks of every
// 2m x 2m block; rows known to be 0 fold away.
__device__ __forceinline__ void transpose32(u32 (&A)[32])
{
#pragma unroll
    for (int t = 0; t < 5; t++) {
        const int m = 16 >> t;
        const u32 lo = 0xffffffffu / ((1u << m) + 1u);   // 0x0000ffff ...
#pragma unroll
        for (int k = 0; k < 32; k++) {
            if (k & m)
                continue;
            u32 x = ((A[k] >> m) ^ A[k + m]) & lo;
            A[k + m] ^= x;
            A[k] ^= x << m;
        }
    }
}

// Grid: tiles of EV_T words (32 positions each); a block writes every plane
// of its tile, a thread one word of each plane.  Shared memory: the code's
// planes and the N words of the tile and its right halo (built once), then
// a [32][33] staging tile per warp.  Per plane, a thread takes its word w
// and w + 1 (for the 8-windows that start in w): eq of the plane's 8 rows
// from the planes, the overlay with anchor rows g*8 - 2 .. g*8 + 9 (loads
// of consecutive words by consecutive threads), the 24 bit-rows q6, q7, pm,
// one transpose to 32 int32, and through the warp's staging tile 32 stores
// of 128 contiguous bytes.  A motif row's overlay word leaves as it is
// formed (consecutive threads, consecutive words of the row), masked to
// positions < L; the thread of word W (when OW = W + 1) stores the row's
// zero pad.
__global__ void __launch_bounds__(EV_T) event_words_kernel(
    const uint8_t *__restrict__ code, const uint8_t *__restrict__ nmask,
    const u32 *__restrict__ anch, int L, int min_shift, int ns, int ngroups,
    int W, int32_t *__restrict__ out, int r0, int nm, int OW,
    u32 *__restrict__ ov_out)
{
    extern __shared__ u32 sw[];
    const int s_max = min_shift + ns - 1;
    const int EW = EV_T + (s_max + 31) / 32 + 2;  // the last eq reads word
    u32 *lo = sw, *hi = lo + EW, *nw = hi + EW;   // EV_T + s_max / 32 + 1
    u32 *st = nw + EW;                            // [EV_WARPS][32][33]

    const int w0 = blockIdx.x * EV_T;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    plane_words<true, EV_PU>(code, nmask, L, w0, EW, lo, hi, nw);
    __syncthreads();

    const int i = threadIdx.x, w = w0 + i;
    const u32 L0 = lo[i], L1 = lo[i + 1], H0 = hi[i], H1 = hi[i + 1];
    u32 nany = nw[i];
#pragma unroll
    for (int j = 1; j < 8; j++)
        nany |= __funnelshift_r(nw[i], nw[i + 1], j);
    const u32 nfree = ~nany, notn = ~nw[i];
    const u32 inl = w < W - 1 ? ~0u                 // bits at positions < L
                    : w == W - 1 && (L & 31) ? (1u << (L & 31)) - 1u
                    : w == W - 1 ? ~0u : 0u;
    u32 *sg = st + warp * (32 * 33);
    const int wb = w0 + warp * 32;                // the warp's first word
    for (int g = 0; g < ngroups; g++) {
        u32 A0[AROWS], A1[AROWS];                 // anchors at w, w + 1
#pragma unroll
        for (int rr = 0; rr < AROWS; rr++) {
            int row = g * OUT_ROWS - 2 + rr;
            bool ok = row >= 0 && row < ns;
            A0[rr] = ok && w < W ? anch[(size_t)row * W + w] : 0u;
            A1[rr] = ok && w + 1 < W ? anch[(size_t)row * W + w + 1] : 0u;
        }
        u32 R[32];
#pragma unroll
        for (int k = 0; k < OUT_ROWS; k++) {
            const int row = g * OUT_ROWS + k;
            u32 e0 = 0, e1 = 0;                   // rows past ns: eq = 0
            if (row < ns) {                       // uniform in the block
                const int s = min_shift + row, q = s >> 5, b = s & 31;
                u32 la = lo[i + q], lb = lo[i + q + 1], lc = lo[i + q + 2];
                u32 ha = hi[i + q], hb = hi[i + q + 1], hc = hi[i + q + 2];
                e0 = eq_planes(L0, H0, la, lb, ha, hb, b);
                e1 = eq_planes(L1, H1, lb, lc, hb, hc, b);
            }
            u32 o0 = e0 | A0[k] | A0[k + 1] | A0[k + 3] | A0[k + 4];
            u32 o1 = e1 | A1[k] | A1[k + 1] | A1[k + 3] | A1[k + 4];
            const int d = row - r0;               // uniform in the block
            if (d >= 0 && d < nm && w < OW)
                ov_out[(size_t)d * OW + w] = o0 & inl;
            R[k] = few_zeros(o0, o1, 0u) & nfree;                // q6
            R[OUT_ROWS + k] = few_zeros(e0, e1, ~0u) & nfree;   // q7
            R[2 * OUT_ROWS + k] = e0 & notn;                    // pm
            R[3 * OUT_ROWS + k] = 0u;
        }
        transpose32(R);                           // R[j]: position 32 w + j
        __syncwarp();
#pragma unroll
        for (int j = 0; j < 32; j++)
            sg[lane * 33 + j] = R[j];
        __syncwarp();
        int32_t *o = out + (size_t)g * L + (size_t)wb * 32 + lane;
        const int rem = L - wb * 32 - lane;       // > 32 j: o[32 j] in the row
#pragma unroll 8
        for (int j = 0; j < 32; j++)
            if (rem > 32 * j)
                o[32 * j] = (int32_t)sg[j * 33 + lane];
    }
}

#define DM_T 256       // dense pass: threads a block, one word of a row each
#define DM_PU 8        // dense pass: code words a warp loads at once
#define FULL 0xffffffffu

// Bit t (t < 32): bits t .. t + c - 1 of the 64-bit x1:x0 are all ones,
// for 1 <= c <= 32; log-doubling ANDs.
__device__ __forceinline__ u32 ones_from(u32 x0, u32 x1, int c)
{
    int k = 1;
    for (; 2 * k <= c; k *= 2) {
        x0 &= __funnelshift_r(x0, x1, k);
        x1 &= x1 >> k;
    }
    return x0 & __funnelshift_r(x0, x1, c - k);
}

// The ones of a pm run that has len of them up to plane word j and goes on
// into x, the pm word j + 1 (pm = eq of shift 32 q + b and not N): is the
// run at least c long?  Walks on past pm words of all ones only; positions
// >= L are N, so no walk passes L.  Rare: only runs of 32 or more come here.
__device__ __noinline__ bool run_reaches(const u32 *lo, const u32 *hi,
                                         const u32 *nw, int j, int q, int b,
                                         int len, u32 x, int c)
{
    for (;;) {
        const int n = __clz(__brev(~x));
        len += n;
        if (n < 32 || len >= c)
            return len >= c;
        j++;
        x = eq_planes(lo[j + 1], hi[j + 1], lo[j + 1 + q], lo[j + 2 + q],
                      hi[j + 1 + q], hi[j + 2 + q], b) & ~nw[j + 1];
    }
}

// Bytes 0-3: bits 4n .. 4n + 3 of x as 0/1 bytes.  The four partial
// products of the multiply land on distinct bits, so nothing carries.
__device__ __forceinline__ u32 nibble_bytes(u32 x, int n)
{
    return ((x >> (4 * n)) & 0xfu) * 0x00204081u & 0x01010101u;
}

// Positions P .. P + 15 of a plane row of length L from bits 0-15 of v: one
// streaming 16-byte store where all 16 lie in the row (row + P is then
// 16-byte aligned), else the bytes in [0, L) one by one (the row's head and
// tail).
__device__ __forceinline__ void put16(int8_t *row, int P, u32 v, int L)
{
    if (P >= 0 && P <= L - 16) {
        __stcs((uint4 *)(row + P),
               make_uint4(nibble_bytes(v, 0), nibble_bytes(v, 1),
                          nibble_bytes(v, 2), nibble_bytes(v, 3)));
    } else {
        for (int t = 0; t < 16; t++) {
            const long long p = (long long)P + t;
            if (p >= 0 && p < L)
                row[p] = (int8_t)((v >> t) & 1u);
        }
    }
}

__device__ __forceinline__ u32 anch_at(const u32 *__restrict__ anch, int row,
                                       int ns, int w, int W)
{
    return row >= 0 && row < ns && w >= 0 && w < W
               ? __ldg(anch + (size_t)row * W + w) : 0u;
}

// Grid: tiles of DM_T words (31 of each 32 if lap).  A block builds the
// code's two bit-planes and the N words over its tile, the word before it
// (pm[p - 1] at the tile's first position) and NP - DM_T - 1 more (eq reads
// s_max / 32 + 2 words ahead, the perfect-run walk ceil(cut_max / 32)) once
// by __ballot_sync.  Then a thread owns one word w, 32 positions, of every
// motif row, row after row with no barrier:
//   eq of words w - 1, w and w + 1 from the planes (eq_planes); the overlay
//   with anchor rows r - 2 .. r + 2 at w and w + 1 as a rolling window of
//   registers, one row of coalesced loads ahead; q7, q6 by bit-sliced
//   window counters and pm as in the event pass; ps = the pm-run starts
//   whose run reaches the cutoff c: for c <= 32 an AND of c shifted copies
//   of the pm pair (w, w + 1) by log-doubling, for c > 32 only the run
//   through bit 31, measured by __clz and walked on past all-ones words;
//   then each plane's 32 bits become 32 bytes, two 16-byte streaming stores.
// A plane row starts at (pl nm + k) L bytes, so for L % 16 != 0 rows sit at
// every offset a of the 16-byte grid (lap = 1).  Then lane 0 of each warp
// works the word before its 31 (and stores nothing), and every other lane
// shifts its 32 positions down by a with its lower neighbour's bits
// (__shfl_up_sync), so its stores land on the grid; the row's head and tail
// go byte by byte.  A warp stores a row's 64 pieces of 16 bytes (two a
// word) as two instructions of 512 contiguous bytes: lane l writes pieces l
// and 32 + l, taken from lanes l / 2 and 16 + l / 2 by __shfl_sync.
__global__ void __launch_bounds__(DM_T) dense_masks_kernel(
    const uint8_t *__restrict__ code, const uint8_t *__restrict__ nmask,
    const u32 *__restrict__ anch, int L, int min_shift, int ns, int r0,
    int nm, int NP, int lap, int8_t *__restrict__ out)
{
    extern __shared__ u32 sw[];
    u32 *lo = sw, *hi = lo + NP, *nw = hi + NP;
    const int W = (L + 31) >> 5;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wpb = DM_T - lap * (DM_T / 32);     // words a block stores
    const int w0 = blockIdx.x * wpb, wb = w0 - 1 - lap;   // wb: word of lo[0]
    plane_words<true, DM_PU>(code, nmask, L, wb, NP, lo, hi, nw);
    __syncthreads();

    const int w = w0 + warp * (32 - lap) + lane - lap, j = w - wb;
    const u32 Lm = lo[j - 1], Hm = hi[j - 1], L0 = lo[j], H0 = hi[j];
    const u32 L1 = lo[j + 1], H1 = hi[j + 1];
    const u32 notnm = ~nw[j - 1], notn = ~nw[j], notn1 = ~nw[j + 1];
    u32 nany = nw[j];
#pragma unroll
    for (int t = 1; t < 8; t++)
        nany |= __funnelshift_r(nw[j], nw[j + 1], t);
    const u32 nfree = ~nany;

    // anchor rows r - 2 .. r + 2 at words w (a..) and w + 1 (b..)
    u32 am2 = anch_at(anch, r0 - 2, ns, w, W);
    u32 bm2 = anch_at(anch, r0 - 2, ns, w + 1, W);
    u32 am1 = anch_at(anch, r0 - 1, ns, w, W);
    u32 bm1 = anch_at(anch, r0 - 1, ns, w + 1, W);
    u32 a00 = anch_at(anch, r0, ns, w, W);
    u32 b00 = anch_at(anch, r0, ns, w + 1, W);
    u32 ap1 = anch_at(anch, r0 + 1, ns, w, W);
    u32 bp1 = anch_at(anch, r0 + 1, ns, w + 1, W);
    u32 ap2 = anch_at(anch, r0 + 2, ns, w, W);
    u32 bp2 = anch_at(anch, r0 + 2, ns, w + 1, W);
    for (int k = 0; k < nm; k++) {
        const int r = r0 + k;
        const u32 an = anch_at(anch, r + 3, ns, w, W);       // in flight
        const u32 bn = anch_at(anch, r + 3, ns, w + 1, W);
        const int s = min_shift + r, q = s >> 5, b = s & 31;
        const int c = s <= 6 ? 12 - s : s;
        const u32 la = lo[j + q - 1], lb = lo[j + q], lc = lo[j + q + 1];
        const u32 ld = lo[j + q + 2], ha = hi[j + q - 1], hb = hi[j + q];
        const u32 hc = hi[j + q + 1], hd = hi[j + q + 2];
        const u32 em = eq_planes(Lm, Hm, la, lb, ha, hb, b);
        const u32 e0 = eq_planes(L0, H0, lb, lc, hb, hc, b);
        const u32 e1 = eq_planes(L1, H1, lc, ld, hc, hd, b);
        const u32 o0 = e0 | am2 | am1 | ap1 | ap2;
        const u32 o1 = e1 | bm2 | bm1 | bp1 | bp2;
        const u32 pm = e0 & notn, pm1 = e1 & notn1;
        const u32 pprev = (em & notnm) >> 31;
        u32 ps = 0;
        if (c <= 32) {                                 // uniform in the grid
            ps = pm & ~(pm << 1 | pprev) & ones_from(pm, pm1, c);
        } else {
            const int top = __clz(~pm);                // ones through bit 31
            if (top && (top < 32 || !pprev)
                && run_reaches(lo, hi, nw, j, q, b, top, pm1, c))
                ps = 1u << (32 - top);
        }
        const u32 V[4] = {few_zeros(e0, e1, ~0u) & nfree,       // q7
                          few_zeros(o0, o1, 0u) & nfree,        // q6
                          ps, pm};
#pragma unroll
        for (int pl = 0; pl < 4; pl++) {
            int8_t *row = out + ((size_t)pl * nm + k) * L;
            u32 v = V[pl];
            int a = 0;
            if (lap) {                                 // uniform in the grid
                a = (int)((uintptr_t)row & 15);
                const u32 pv = __shfl_up_sync(FULL, v, 1);
                v = __funnelshift_rc(pv, v, 32 - a);
            }
#pragma unroll
            for (int h = 0; h < 2; h++) {              // pieces 32 h + lane
                const int ci = 32 * h + lane, src = ci >> 1;
                const u32 x = __shfl_sync(FULL, v, src) >> (16 * (ci & 1));
                // wraps (so is negative) only past 2^31 positions, >= L
                const int P = (int)(32u * (u32)(w - lane + src)
                                    + 16 * (ci & 1) - a);
                if (src >= lap)
                    put16(row, P, x, L);
            }
        }
        am2 = am1; am1 = a00; a00 = ap1; ap1 = ap2; ap2 = an;
        bm2 = bm1; bm1 = b00; b00 = bp1; bp1 = bp2; bp2 = bn;
    }
}

static int launch_smem(const void *fn, size_t smem)
{
    if (smem > 48 * 1024)
        return (int)cudaFuncSetAttribute(
            fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    return 0;
}

// All pointers are device pointers on `device`; the launch goes onto
// `stream` and does not synchronise.  Returns cudaGetLastError().
extern "C" int ribbit_anchor_planes(const uint8_t *code, int L, int min_shift,
                                    int ns, u32 *out, int W, int device,
                                    cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int s_max = min_shift + ns - 1;
    const int K = (2 * s_max + 31) / 32;
    const int NP = AT + 2 * (K + 1) + (s_max >> 5) + 1;
    const size_t smem = (size_t)2 * NP * sizeof(u32);
    int rc = launch_smem((const void *)anchor_planes_kernel, smem);
    if (rc)
        return rc;
    anchor_planes_kernel<<<(W + AT - 1) / AT, AT, smem, stream>>>(
        code, L, min_shift, ns, K, out, W);
    return (int)cudaGetLastError();
}

// Motif rows are shift rows r0 .. r0 + nm - 1; ov_out, int32 [nm, OW]
// with OW = 2 ceil(L / 64).
extern "C" int ribbit_event_words(const uint8_t *code, const uint8_t *nmask,
                                  const u32 *anch, int L, int min_shift,
                                  int ns, int ngroups, int32_t *out, int r0,
                                  int nm, u32 *ov_out, int device,
                                  cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int s_max = min_shift + ns - 1;
    const int W = (L + 31) / 32;
    const int OW = 2 * (int)(((long long)L + 63) / 64);   // W or W + 1
    const int EW = EV_T + (s_max + 31) / 32 + 2;
    const size_t smem = (size_t)(3 * EW + EV_WARPS * 32 * 33) * sizeof(u32);
    int rc = launch_smem((const void *)event_words_kernel, smem);
    if (rc)
        return rc;
    event_words_kernel<<<(OW + EV_T - 1) / EV_T, EV_T, smem, stream>>>(
        code, nmask, anch, L, min_shift, ns, ngroups, W, out, r0, nm, OW,
        ov_out);
    return (int)cudaGetLastError();
}

// Motif rows k = 0..nm-1 are shift rows r0 + k.  out: int8 [4, nm, L].
extern "C" int ribbit_dense_masks(const uint8_t *code, const uint8_t *nmask,
                                  const u32 *anch, int L, int min_shift,
                                  int ns, int r0, int nm, int8_t *out,
                                  int device, cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    int cut_max = 0;
    for (int k = 0; k < nm; k++) {
        int m = min_shift + r0 + k;
        int c = m <= 6 ? 12 - m : m;
        cut_max = c > cut_max ? c : cut_max;
    }
    const int s_max = min_shift + r0 + nm - 1;
    const int W = (L + 31) / 32;
    const int lap = (((uintptr_t)out | (uintptr_t)L) & 15) ? 1 : 0;
    const int wpb = DM_T - lap * (DM_T / 32);
    const int NP = DM_T + (cut_max + 31) / 32 + (s_max >> 5) + 3;
    const size_t smem = (size_t)3 * NP * sizeof(u32);
    int rc = launch_smem((const void *)dense_masks_kernel, smem);
    if (rc)
        return rc;
    dense_masks_kernel<<<(W + lap + wpb - 1) / wpb, DM_T, smem, stream>>>(
        code, nmask, anch, L, min_shift, ns, r0, nm, NP, lap, out);
    return (int)cudaGetLastError();
}
