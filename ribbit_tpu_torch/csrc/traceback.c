/* Batched banded traceback for the port's device-batched refinement
 * (ribbit_tpu_torch/refine_batched.py).
 *
 * The SSW forward and reverse passes run on the card and locate each
 * alignment (score, ref and read begin and end).  What remains per pair is
 * ribbit_align's tail: banded_sw over the located sub-pair, then the
 * '='/'X' split with the soft clips (align.banded_sw + align._mark_mismatch
 * in the numpy spec).  banded_sw is static in the shared C core, so this
 * file includes that source whole (unchanged) and builds as a library of
 * its own (native.get_traceback_lib); the core's other symbols come along
 * but no library holds them twice.
 *
 * ribbit_traceback_batch takes a whole round's pairs and spreads them over
 * nthreads pthreads.  A shared atomic index hands out pairs, since their
 * sizes span three orders of magnitude; each thread owns its ops buffers,
 * and each pair writes only its own slots, so the output does not depend
 * on the thread count.
 */

#include "../../csrc/ribbit_align.c"

#include <pthread.h>

typedef struct {
    int32_t n;
    const int8_t *reads, *refs;
    const int64_t *read_off, *read_len, *ref_off, *ref_len, *cigar_off;
    const int32_t *score, *ref_begin, *ref_end, *query_begin, *query_end;
    char *cigar;
    int32_t *cigar_len, *mismatches;
    int32_t next;               /* the next pair to take (atomic) */
    int32_t failed;             /* a pair failed (traceback_pair's -1) */
} batch_t;

typedef struct {
    int32_t *len;
    char *ch;
    int32_t cap;
} ops_t;

/* One located pair: banded_sw + the '='/'X' split (ribbit_align's tail,
 * csrc/ribbit_align.c:1045-1134).  A traceback error leaves an empty
 * cigar and 0 mismatches, as the spec's [] ops do.  Returns 0, or -1 when
 * the ops walk off the pair, the cigar overflows its slot or the ops
 * buffers cannot grow. */
static int traceback_pair(const batch_t *b, int32_t k, ops_t *ops) {
    const int8_t *read = b->reads + b->read_off[k];
    const int8_t *ref = b->refs + b->ref_off[k];
    int32_t R = (int32_t)b->read_len[k];
    int32_t C = (int32_t)b->ref_len[k];
    char *buf = b->cigar + b->cigar_off[k];
    int32_t cap = (int32_t)(b->cigar_off[k + 1] - b->cigar_off[k]);
    int32_t ref_begin = b->ref_begin[k], query_begin = b->query_begin[k];
    int32_t query_end = b->query_end[k];
    int32_t sub_ref_len = b->ref_end[k] - ref_begin + 1;
    int32_t sub_read_len = query_end - query_begin + 1;
    int32_t bw = sub_ref_len - sub_read_len;
    if (bw < 0) bw = -bw;
    bw += 1;

    b->cigar_len[k] = 0;
    b->mismatches[k] = 0;
    buf[0] = 0;
    int32_t need = 2 * (sub_ref_len + sub_read_len) + 8;
    if (need > ops->cap) {
        int32_t *len = (int32_t *)realloc(ops->len,
                                          (size_t)need * sizeof(int32_t));
        if (!len) return -1;
        ops->len = len;
        char *ch = (char *)realloc(ops->ch, (size_t)need);
        if (!ch) return -1;
        ops->ch = ch;
        ops->cap = need;
    }
    int32_t nops = banded_sw(ref + ref_begin, sub_ref_len,
                             read + query_begin, sub_read_len,
                             b->score[k], bw, ops->len, ops->ch, ops->cap);
    if (nops < 0) return 0;     /* traceback error: empty cigar */

    int32_t pos = 0, mism = 0;
    if (query_begin > 0 &&
        (pos = emit_num(buf, pos, cap, query_begin, 'S')) < 0)
        goto overflow;
    int32_t rp = ref_begin, qp = query_begin;
    int32_t run_len = 0;
    char run_op = 0;
    for (int32_t t = 0; t < nops; t++) {
        int32_t ln = ops->len[t];
        char op = ops->ch[t];
        if (op == 'M') {
            /* a target score the pair cannot reach can walk the ops past
             * the pair's end (the spec then raises IndexError) */
            if (rp + ln > C || qp + ln > R) goto overflow;
            for (int32_t s = 0; s < ln; s++, rp++, qp++) {
                /* raw codes, as the spec compares them: N == N is '=' */
                char ch = ref[rp] == read[qp] ? '=' : 'X';
                mism += ch == 'X';
                if (ch == run_op) {
                    run_len++;
                    continue;
                }
                if (run_len &&
                    (pos = emit_num(buf, pos, cap, run_len, run_op)) < 0)
                    goto overflow;
                run_op = ch;
                run_len = 1;
            }
            continue;
        }
        if (run_len &&
            (pos = emit_num(buf, pos, cap, run_len, run_op)) < 0)
            goto overflow;
        run_len = 0;
        run_op = 0;
        if ((pos = emit_num(buf, pos, cap, ln, op)) < 0)
            goto overflow;
        if (op == 'I') qp += ln;
        else rp += ln;
        mism += ln;
    }
    if (run_len && (pos = emit_num(buf, pos, cap, run_len, run_op)) < 0)
        goto overflow;
    if (R - query_end - 1 > 0 &&
        (pos = emit_num(buf, pos, cap, R - query_end - 1, 'S')) < 0)
        goto overflow;
    buf[pos] = 0;
    b->cigar_len[k] = pos;
    b->mismatches[k] = mism;
    return 0;

overflow:
    buf[0] = 0;
    return -1;
}

static void *traceback_worker(void *arg) {
    batch_t *b = (batch_t *)arg;
    ops_t ops = {NULL, NULL, 0};
    for (;;) {
        int32_t k = __atomic_fetch_add(&b->next, 1, __ATOMIC_RELAXED);
        if (k >= b->n) break;
        if (traceback_pair(b, k, &ops) < 0)
            __atomic_store_n(&b->failed, 1, __ATOMIC_RELAXED);
    }
    free(ops.len);
    free(ops.ch);
    return NULL;
}

/* Pair k: read reads[read_off[k]:read_off[k]+read_len[k]], ref likewise
 * (pairs may lie anywhere in the buffers, in any order), located at
 * ref[ref_begin..ref_end] and read[query_begin..query_end] (inclusive,
 * checked by the caller) with SW score score[k].  Its cigar goes to
 * cigar[cigar_off[k]:cigar_off[k+1]] NUL-terminated, its length to
 * cigar_len[k] and its mismatch count to mismatches[k].  Returns 0, or -1
 * if any pair's ops walked off it, its cigar overflowed its slot or
 * memory could not be had (every pair is still attempted). */
int ribbit_traceback_batch(int32_t n,
                           const int8_t *reads, const int64_t *read_off,
                           const int64_t *read_len,
                           const int8_t *refs, const int64_t *ref_off,
                           const int64_t *ref_len,
                           const int32_t *score, const int32_t *ref_begin,
                           const int32_t *ref_end,
                           const int32_t *query_begin,
                           const int32_t *query_end,
                           char *cigar, const int64_t *cigar_off,
                           int32_t *cigar_len, int32_t *mismatches,
                           int32_t nthreads) {
    batch_t b = {n, reads, refs, read_off, read_len, ref_off, ref_len,
                 cigar_off, score,
                 ref_begin, ref_end, query_begin, query_end, cigar,
                 cigar_len, mismatches, 0, 0};
    if (nthreads > n) nthreads = n;
    if (nthreads < 1) nthreads = 1;
    pthread_t *tids = (pthread_t *)malloc((size_t)nthreads *
                                          sizeof(pthread_t));
    if (!tids) return -1;
    int32_t started = 0;
    for (; started < nthreads - 1; started++)
        if (pthread_create(&tids[started], NULL, traceback_worker, &b))
            break;              /* fewer threads take the same pairs */
    traceback_worker(&b);       /* the calling thread takes pairs too */
    for (int32_t t = 0; t < started; t++) pthread_join(tids[t], NULL);
    free(tids);
    return b.failed ? -1 : 0;
}
