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
// x 4 B) and that plane then crosses PCIe to the host, so the output bytes
// bound the pass; compute is about ns x (an 8-bit window popcount twice,
// four neighbour ORs) integer ops per bp.  The dense pass writes 4 B per
// motif row per bp (396 B/bp at the default config) against 14.75 B/bp
// read, so it too is bound by its output bytes.  The design keeps every
// per-position quantity as a bit in a 32-bit word: eq is built once per
// block into shared memory as bit-words, run searches use __clz / __ffs
// over whole words, and an 8-position window is one __funnelshift_r plus
// __popc.  Each output word is written once, coalesced; the dense pass
// writes four positions of a plane per 32-bit store.

#include <cuda_runtime.h>
#include <stdint.h>

typedef uint32_t u32;

#define THREADS 256
#define TW 64          // bit-words (of 32 positions) per block tile
#define RA 8           // shift rows per block in the anchor pass
#define OUT_ROWS 8     // shift rows per output plane in the event pass

// eq bit-word for word-local offset lb (byte offset of the word's first
// position in the shared code tile), global position p0 of its bit 0 and
// shift s; bits at p < 0 or p >= lim are 0.
__device__ __forceinline__ u32 eq_word(const uint8_t *sc, int lb, int p0,
                                       int s, int lim)
{
    u32 w = 0;
#pragma unroll 8
    for (int j = 0; j < 32; j++) {
        int p = p0 + j;
        if (p >= 0 && p < lim && sc[lb + j] == sc[lb + j + s])
            w |= 1u << j;
    }
    return w;
}

// Grid: (tiles of TW words, groups of RA rows).  Shared memory: the code
// tile over words [w0 - K, w0 + TW + K) plus s_max bytes, then the eq
// bit-words of RA rows over the same words.  K words of halo on each side
// cover 2 * s_max + 32 positions, so any run that reaches past them is
// longer than 2s and cannot be an anchor.
__global__ void anchor_planes_kernel(const uint8_t *__restrict__ code, int L,
                                     int min_shift, int ns, int K,
                                     u32 *__restrict__ out, int W)
{
    extern __shared__ unsigned char smem[];
    const int EW = TW + 2 * K;                 // words in the extended tile
    const int s_max = min_shift + ns - 1;
    const int ncode = EW * 32 + s_max;
    uint8_t *sc = smem;
    u32 *eqs = (u32 *)(smem + ((ncode + 15) & ~15));

    const int w0 = blockIdx.x * TW;
    const int row0 = blockIdx.y * RA;
    const int pbase = (w0 - K) * 32;           // global position of sc[0]

    for (int i = threadIdx.x; i < ncode; i += THREADS) {
        int p = pbase + i;
        sc[i] = (p >= 0 && p < L) ? code[p] : 0;
    }
    __syncthreads();

    // neighbouring threads take neighbouring rows of one word: they read
    // the same code byte and consecutive shifted bytes
    for (int i = threadIdx.x; i < RA * EW; i += THREADS) {
        int r = i % RA, wl = i / RA;
        int row = row0 + r;
        u32 w = 0;
        if (row < ns) {
            int s = min_shift + row;
            w = eq_word(sc, wl * 32, pbase + wl * 32, s, L - s);
        }
        eqs[r * EW + wl] = w;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < RA * TW; i += THREADS) {
        int r = i % RA, wl = i / RA;
        int row = row0 + r, gw = w0 + wl;
        if (row >= ns || gw >= W)
            continue;
        const int s = min_shift + row;
        const int hi = L - s;                  // runs must close before hi
        const u32 *e = eqs + r * EW;
        const int we = K + wl;                 // this word in eqs
        u32 rem = e[we], anch = 0;
        while (rem) {
            int a = __ffs(rem) - 1;            // first run bit in the word
            u32 tail = ~(rem >> a);
            // run is bits [a, b); tail has ones above bit 31 - a
            int b = (tail == 0) ? 32 : a + __ffs(tail) - 1;
            int left = 0, right = 0;
            if (a == 0) {                      // run may start earlier
                for (int k = we - 1; k >= 0 && left < 2 * s; k--) {
                    int c = __clz(~e[k]);
                    left += c;
                    if (c < 32) break;
                }
            }
            if (b == 32) {                     // run may end later
                for (int k = we + 1; k < EW && right < 2 * s; k++) {
                    u32 nx = ~e[k];
                    int c = nx ? __ffs(nx) - 1 : 32;
                    right += c;
                    if (c < 32) break;
                }
            }
            int len = left + (b - a) + right;
            int end = gw * 32 + b + right;     // exclusive run end
            u32 bits = (b == 32 ? 0xffffffffu : ((1u << b) - 1u))
                       & ~((1u << a) - 1u);
            if (len >= 3 && len < 2 * s && end < hi)
                anch |= bits;
            rem &= ~bits;
        }
        out[(size_t)row * W + gw] = anch;
    }
}

// Grid: (tiles of TW * 32 positions, output planes).  Shared memory: the
// code tile over words [w0, w0 + TW + 1) plus s_max bytes, the n_mask
// tile, the N bit-words (positions >= L set), and eq and overlay
// bit-words of the plane's 8 rows.  The extra word serves windows that
// start in the tile's last word.
__global__ void event_words_kernel(const uint8_t *__restrict__ code,
                                   const uint8_t *__restrict__ nmask,
                                   const u32 *__restrict__ anch, int L,
                                   int min_shift, int ns, int W,
                                   int32_t *__restrict__ out)
{
    extern __shared__ unsigned char smem[];
    const int EW = TW + 1;
    const int s_max = min_shift + ns - 1;
    const int ncode = EW * 32 + s_max;
    uint8_t *sc = smem;
    uint8_t *sn = smem + ((ncode + 15) & ~15);
    u32 *nw = (u32 *)(sn + EW * 32);
    u32 *eqw = nw + EW;
    u32 *ovw = eqw + OUT_ROWS * EW;

    const int w0 = blockIdx.x * TW;
    const int g = blockIdx.y;
    const int pbase = w0 * 32;

    for (int i = threadIdx.x; i < ncode; i += THREADS) {
        int p = pbase + i;
        sc[i] = p < L ? code[p] : 0;
        if (i < EW * 32)
            sn[i] = p < L ? nmask[p] : 1;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < EW; i += THREADS) {
        u32 w = 0;
        for (int j = 0; j < 32; j++)
            w |= (u32)(sn[i * 32 + j] != 0) << j;
        nw[i] = w;
    }
    for (int i = threadIdx.x; i < OUT_ROWS * EW; i += THREADS) {
        int r = i % OUT_ROWS, wl = i / OUT_ROWS;
        int row = g * OUT_ROWS + r, gw = w0 + wl;
        u32 eq = 0, ov = 0;
        if (row < ns) {
            int s = min_shift + row;
            eq = eq_word(sc, wl * 32, pbase + wl * 32, s, L);
        }
        if (gw < W) {
            for (int d = -2; d <= 2; d++) {
                int nr = row + d;
                if (d != 0 && nr >= 0 && nr < ns)
                    ov |= anch[(size_t)nr * W + gw];
            }
        }
        eqw[r * EW + wl] = eq;
        ovw[r * EW + wl] = eq | ov;
    }
    __syncthreads();

    for (int pl = threadIdx.x; pl < TW * 32; pl += THREADS) {
        int p = pbase + pl;
        if (p >= L)
            break;
        int wl = pl >> 5, sh = pl & 31;
        u32 n8 = __funnelshift_r(nw[wl], nw[wl + 1], sh) & 0xffu;
        bool nfree = n8 == 0;
        u32 word = 0;
#pragma unroll
        for (int r = 0; r < OUT_ROWS; r++) {
            u32 e8 = __funnelshift_r(eqw[r * EW + wl], eqw[r * EW + wl + 1],
                                     sh) & 0xffu;
            u32 o8 = __funnelshift_r(ovw[r * EW + wl], ovw[r * EW + wl + 1],
                                     sh) & 0xffu;
            u32 q6 = nfree && __popc(o8) >= 6;
            u32 q7 = nfree && __popc(e8) >= 7;
            u32 pm = (e8 & 1u) & ~n8;
            word |= (q6 << r) | (q7 << (OUT_ROWS + r))
                    | ((pm & 1u) << (2 * OUT_ROWS + r));
        }
        out[(size_t)g * L + p] = (int32_t)word;
    }
}

#define MROWS 8        // motif rows per block in the dense pass

// Length of the pm run from bit b of word wl is at least cutoff; pm words
// are eq & ~N, walked past the word with __ffs as the anchor pass does.
__device__ __forceinline__ bool run_at_least(const u32 *e, const u32 *nw,
                                             int wl, int b, int cutoff,
                                             int EW)
{
    u32 inv = ~((e[wl] & ~nw[wl]) >> b);   // ones above bit 31 - b
    int len = inv ? __ffs(inv) - 1 : 32;
    if (len < 32 - b)
        return len >= cutoff;
    for (int k = wl + 1; k < EW && len < cutoff; k++) {
        u32 nx = ~(e[k] & ~nw[k]);
        int c = nx ? __ffs(nx) - 1 : 32;
        len += c;
        if (c < 32)
            break;
    }
    return len >= cutoff;
}

// Grid: (tiles of TW words, groups of MROWS motif rows).  Shared memory:
// the code tile over words [w0 - 1, w0 + TW + H) plus s_max bytes, the
// n_mask tile, the N bit-words (positions < 0 or >= L set), and eq and
// overlay bit-words of the group's rows over the same words.  The left word
// gives pm[p - 1] at the tile's first position; the H right words serve
// windows that start in the tile's last word and the run walk up to the
// largest cutoff.  A thread takes four positions of one row.
__global__ void dense_masks_kernel(const uint8_t *__restrict__ code,
                                   const uint8_t *__restrict__ nmask,
                                   const u32 *__restrict__ anch, int L,
                                   int min_shift, int ns, int r0, int nm,
                                   int H, int W, int8_t *__restrict__ out)
{
    extern __shared__ unsigned char smem[];
    const int EW = 1 + TW + H;
    const int s_max = min_shift + r0 + nm - 1;
    const int ncode = EW * 32 + s_max;
    uint8_t *sc = smem;
    uint8_t *sn = smem + ((ncode + 15) & ~15);
    u32 *nw = (u32 *)(sn + EW * 32);
    u32 *eqw = nw + EW;
    u32 *ovw = eqw + MROWS * EW;

    const int w0 = blockIdx.x * TW;
    const int k0 = blockIdx.y * MROWS;
    const int pbase = (w0 - 1) * 32;           // global position of sc[0]

    for (int i = threadIdx.x; i < ncode; i += THREADS) {
        int p = pbase + i;
        bool in = p >= 0 && p < L;
        sc[i] = in ? code[p] : 0;
        if (i < EW * 32)
            sn[i] = in ? nmask[p] : 1;
    }
    __syncthreads();

    for (int i = threadIdx.x; i < EW; i += THREADS) {
        u32 w = 0;
        for (int j = 0; j < 32; j++)
            w |= (u32)(sn[i * 32 + j] != 0) << j;
        nw[i] = w;
    }
    for (int i = threadIdx.x; i < MROWS * EW; i += THREADS) {
        int r = i % MROWS, wl = i / MROWS;
        int k = k0 + r, gw = w0 - 1 + wl;
        u32 eq = 0, ov = 0;
        if (k < nm) {
            int row = r0 + k;
            eq = eq_word(sc, wl * 32, pbase + wl * 32, min_shift + row, L);
            if (gw >= 0 && gw < W) {
                for (int d = -2; d <= 2; d++) {
                    int nr = row + d;
                    if (d != 0 && nr >= 0 && nr < ns)
                        ov |= anch[(size_t)nr * W + gw];
                }
            }
        }
        eqw[r * EW + wl] = eq;
        ovw[r * EW + wl] = eq | ov;
    }
    __syncthreads();

    const int QT = TW * 8;                     // quads of positions per row
    for (int i = threadIdx.x; i < MROWS * QT; i += THREADS) {
        int r = i / QT, q = i % QT;
        int k = k0 + r;
        int p = w0 * 32 + 4 * q;
        if (k >= nm)
            break;
        if (p >= L)
            continue;
        int wl = 1 + (q >> 3), sh = (q & 7) * 4;
        int m = min_shift + r0 + k;
        int cutoff = m <= 6 ? 12 - m : m;
        const u32 *e = eqw + r * EW, *o = ovw + r * EW;
        u32 n8 = __funnelshift_r(nw[wl], nw[wl + 1], sh);
        u32 e8 = __funnelshift_r(e[wl], e[wl + 1], sh);
        u32 o8 = __funnelshift_r(o[wl], o[wl + 1], sh);
        u32 pmb = e8 & ~n8;
        u32 prev = sh ? (e[wl] & ~nw[wl]) >> (sh - 1)
                      : (e[wl - 1] & ~nw[wl - 1]) >> 31;
        u32 v7 = 0, v6 = 0, vs = 0, vm = 0;
#pragma unroll
        for (int j = 0; j < 4; j++) {
            bool nfree = ((n8 >> j) & 0xffu) == 0;
            u32 b7 = nfree && __popc((e8 >> j) & 0xffu) >= 7;
            u32 b6 = nfree && __popc((o8 >> j) & 0xffu) >= 6;
            u32 bm = (pmb >> j) & 1u;
            u32 bp = (j ? pmb >> (j - 1) : prev) & 1u;
            u32 bs = bm && !bp
                     && run_at_least(e, nw, wl, sh + j, cutoff, EW);
            v7 |= b7 << (8 * j);
            v6 |= b6 << (8 * j);
            vs |= bs << (8 * j);
            vm |= bm << (8 * j);
        }
        const u32 v[4] = {v7, v6, vs, vm};
        for (int pl = 0; pl < 4; pl++) {
            int8_t *dst = out + ((size_t)pl * nm + k) * L + p;
            if ((((size_t)dst) & 3) == 0 && p + 3 < L) {
                *(u32 *)dst = v[pl];
            } else {
                for (int j = 0; j < 4 && p + j < L; j++)
                    dst[j] = (int8_t)((v[pl] >> (8 * j)) & 1u);
            }
        }
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
    const int K = (2 * s_max + 31) / 32 + 1;
    const int EW = TW + 2 * K;
    const size_t smem = (size_t)((EW * 32 + s_max + 15) & ~15)
                        + (size_t)RA * EW * sizeof(u32);
    int rc = launch_smem((const void *)anchor_planes_kernel, smem);
    if (rc)
        return rc;
    dim3 grid((W + TW - 1) / TW, (ns + RA - 1) / RA);
    anchor_planes_kernel<<<grid, THREADS, smem, stream>>>(
        code, L, min_shift, ns, K, out, W);
    return (int)cudaGetLastError();
}

extern "C" int ribbit_event_words(const uint8_t *code, const uint8_t *nmask,
                                  const u32 *anch, int L, int min_shift,
                                  int ns, int ngroups, int32_t *out,
                                  int device, cudaStream_t stream)
{
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess)
        return (int)err;
    const int s_max = min_shift + ns - 1;
    const int W = (L + 31) / 32;
    const int EW = TW + 1;
    const size_t smem = (size_t)((EW * 32 + s_max + 15) & ~15)
                        + (size_t)EW * 32
                        + (size_t)(1 + 2 * OUT_ROWS) * EW * sizeof(u32);
    int rc = launch_smem((const void *)event_words_kernel, smem);
    if (rc)
        return rc;
    dim3 grid((L + TW * 32 - 1) / (TW * 32), ngroups);
    event_words_kernel<<<grid, THREADS, smem, stream>>>(
        code, nmask, anch, L, min_shift, ns, W, out);
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
    const int H = (cut_max + 31) / 32 + 1;
    const int s_max = min_shift + r0 + nm - 1;
    const int W = (L + 31) / 32;
    const int EW = 1 + TW + H;
    const size_t smem = (size_t)((EW * 32 + s_max + 15) & ~15)
                        + (size_t)EW * 32
                        + (size_t)(1 + 2 * MROWS) * EW * sizeof(u32);
    int rc = launch_smem((const void *)dense_masks_kernel, smem);
    if (rc)
        return rc;
    dim3 grid((L + TW * 32 - 1) / (TW * 32), (nm + MROWS - 1) / MROWS);
    dense_masks_kernel<<<grid, THREADS, smem, stream>>>(
        code, nmask, anch, L, min_shift, ns, r0, nm, H, W, out);
    return (int)cudaGetLastError();
}
