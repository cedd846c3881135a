/* Alignment rounds of the port's device-batched refinement
 * (ribbit_tpu_torch/refine_batched.py): the per-item host work around the
 * SSW passes on the card, in C.
 *
 * The route refines the merged seed stream in rounds.  A round's pending
 * work items each make zero or more alignment requests (a read of the
 * genome against a pseudo-perfect repeat of the item's motif); the card
 * locates every alignment, the batch traceback (traceback.c) writes each
 * located pair's cigar, and the requests' cigars then give the BED lines
 * and the next round's items (the flank recursion of process_seed).
 *
 *   ribbit_round_requests  what process_seed / process_seed_motifwise do
 *                          before ribbit_align: the n-trim, the overlay
 *                          gate, possible_motifs (m <= 10) or the memoised
 *                          diagonal vote (m > 10, with the m > 128 quirk),
 *                          atomicity, and the read and pseudo-perfect ref of
 *                          each request, written to flat buffers;
 *   ribbit_round_emit      what they do after it: process_cigar_* and
 *                          calculate_motif_units, the gates, emit_line, and
 *                          the flank recursion's children as arrays.
 *
 * The helpers are static in the shared refinement core, so this file
 * includes csrc/ribbit_refine.c whole (unchanged) and the port's core
 * library builds from it in that file's place (core.py): every symbol the
 * core exported is still there once.
 *
 * Both entries hand out fixed chunks of their inputs from an atomic index
 * to nthreads pthreads; each chunk owns its output buffers, and the chunks
 * concatenate in input order, so the output does not depend on the thread
 * count.  Each thread frees its vote memo before it ends, as
 * refine_worker does.
 */

#include "../../csrc/ribbit_refine.c"

#define ROUND_CHUNK 32          /* items or requests a claim */

/* ------------------------------------------------------------------ */
/* requests                                                           */
/* ------------------------------------------------------------------ */

/* One round's requests, in item order.  Request k came from pending item
 * item[k]: candidate cand[k] of possible_motifs (m <= 10), or -1 for the
 * single request of a large-motif item.  It aligns the read
 * reads[read_off[k]:read_off[k+1]] (SSW codes of the genome from a_start,
 * cut at the contig's end) against refs[ref_off[k]:ref_off[k+1]] (the
 * motif's first atom[k] bases tiled to ppr_length_of(a_len, m), codes
 * 0-3).  unit[k] is the candidate's motif unit after the atomicity shift
 * (calculate_motif_units' argument), -1 for large-motif requests. */
typedef struct {
    i64 n;
    i64 *item, *cand, *a_start, *a_len, *atom, *unit;
    i64 *read_off, *ref_off;    /* n + 1 each */
    int8_t *reads, *refs;
} RibbitRound;

typedef struct {                /* one chunk's requests */
    i64 n, cap;
    i64 *f[6];                  /* item, cand, a_start, a_len, atom, unit */
    i64 *read_len, *ref_len;
    int8_t *reads, *refs;
    i64 nread, capread, nref, capref;
} ReqChunk;

static void rq_grow_bytes(int8_t **buf, i64 *cap, i64 need) {
    if (need <= *cap) return;
    i64 c = *cap ? *cap : 4096;
    while (c < need) c *= 2;
    *buf = (int8_t *)xrealloc(*buf, (size_t)c);
    *cap = c;
}

/* append one request: the read translated[a_start:a_start+read_len] and
 * the first `atom` motif bases tiled to ppr_len (build_ppr's tiling) */
static void rq_push(ReqChunk *q, const RefineCtx *x, i64 item, i64 cand,
                    i64 a_start, i64 a_len, i64 atom, i64 unit,
                    i64 read_len, const int8_t *bases, i64 ppr_len) {
    if (q->n == q->cap) {
        q->cap = q->cap ? 2 * q->cap : 16;
        for (int j = 0; j < 6; j++)
            q->f[j] = (i64 *)xrealloc(q->f[j], (size_t)q->cap * sizeof(i64));
        q->read_len = (i64 *)xrealloc(q->read_len,
                                      (size_t)q->cap * sizeof(i64));
        q->ref_len = (i64 *)xrealloc(q->ref_len,
                                     (size_t)q->cap * sizeof(i64));
    }
    i64 v[6] = {item, cand, a_start, a_len, atom, unit};
    for (int j = 0; j < 6; j++) q->f[j][q->n] = v[j];
    if (read_len < 0) read_len = 0;
    if (ppr_len < 0) ppr_len = 0;
    q->read_len[q->n] = read_len;
    q->ref_len[q->n] = ppr_len;
    q->n++;
    rq_grow_bytes(&q->reads, &q->capread, q->nread + read_len);
    memcpy(q->reads + q->nread, x->translated + a_start, (size_t)read_len);
    q->nread += read_len;
    rq_grow_bytes(&q->refs, &q->capref, q->nref + ppr_len);
    for (i64 i = 0; i < ppr_len; i++) q->refs[q->nref + i] = bases[i % atom];
    q->nref += ppr_len;
}

/* one pending item's requests: process_seed_motifwise (m <= 10) and
 * process_seed (m > 10) up to their ribbit_align call, with the C pool's
 * overlay gate (a run of 3; the tests hold it equal to the Python spec's
 * longest run against CONTINUOUS_ONES_THRESHOLD) */
static void round_item(const RefineCtx *x, i64 item, i64 s, i64 e, i64 m,
                       i32 midx, ReqChunk *q) {
    i64 ssl = n_trimmed_length(x, s, e, m);
    if (m <= 10) {
        if (!ribbit_core_overlay_run3(x->core, midx, s, e)) return;
        MotifCands mc = possible_motifs(x, s, ssl, m);
        for (i64 ci = 0; ci < mc.n; ci++) {
            uint64_t unit = (uint64_t)mc.motifs[ci];
            i64 atom = atomicity_int(unit, (i32)m);
            int8_t bases[16];
            motif_int_to_bases(unit, (i32)m, bases);
            i64 ms = mc.starts[ci], msl = mc.ends[ci] - ms;
            i64 read_len = ms + msl > x->L ? x->L - ms : msl;
            rq_push(q, x, item, ci, ms, msl, atom,
                    (i64)(unit >> (2 * (m - atom))), read_len, bases,
                    ppr_length_of(msl, m));
        }
        free(mc.motifs);
        free(mc.starts);
        free(mc.ends);
        return;
    }
    if ((double)(e - s) < 0.9 * (double)m) return;
    if (!ribbit_core_overlay_run3(x->core, midx, s, e)) return;
    int8_t *bases = (int8_t *)xmalloc((size_t)m);
    i32 mm = vote_longer_memo(x, s, ssl, m);
    for (i64 i = 0; i < m; i++) {
        i64 p = mm + i;
        bases[i] = (p < x->L) ? x->code[p] : 0;
    }
    /* QUIRK (process_seed): the uint256_t motif of the reference drops
     * the leading m - 128 bases, which read back as 'A' */
    for (i64 i = 0; i < m - 128; i++) bases[i] = 0;
    i64 atom = atomicity_bases(bases, (i32)m, 0);
    if (m % atom == 0) {
        i64 read_len = s + ssl > x->L ? x->L - s : ssl;
        rq_push(q, x, item, -1, s, ssl, atom, -1, read_len, bases,
                ppr_length_of(ssl, m));
    }
    free(bases);
}

typedef struct {
    RefineCtx x;
    i64 n;
    const i64 *s, *e, *m, *midx;
    ReqChunk *chunks;
    i64 nchunks;
    i64 next;                   /* the next chunk to take (atomic) */
} ReqPool;

static void *req_worker(void *arg) {
    ReqPool *p = (ReqPool *)arg;
    for (;;) {
        i64 c = __atomic_fetch_add(&p->next, 1, __ATOMIC_RELAXED);
        if (c >= p->nchunks) break;
        i64 hi = (c + 1) * ROUND_CHUNK < p->n ? (c + 1) * ROUND_CHUNK : p->n;
        for (i64 i = c * ROUND_CHUNK; i < hi; i++)
            round_item(&p->x, i, p->s[i], p->e[i], p->m[i], (i32)p->midx[i],
                       &p->chunks[c]);
    }
    vcmemo_free();
    return NULL;
}

/* run worker(pool) on nthreads threads, the calling thread among them */
static void run_pool(void *(*worker)(void *), void *pool, i64 nthreads,
                     i64 nchunks) {
    if (nthreads > nchunks) nthreads = nchunks;
    if (nthreads < 1) nthreads = 1;
    pthread_t *tids = (pthread_t *)xmalloc((size_t)nthreads *
                                           sizeof(pthread_t));
    i64 started = 0;
    for (; started < nthreads - 1; started++)
        if (pthread_create(&tids[started], NULL, worker, pool))
            break;              /* fewer threads take the same chunks */
    worker(pool);
    for (i64 t = 0; t < started; t++) pthread_join(tids[t], NULL);
    free(tids);
}

static void round_ctx(RefineCtx *x, RibbitCore *core, const int8_t *code,
                      const uint8_t *nmask, const int8_t *translated, i64 L,
                      const i64 *min_len_tbl, const i64 *perf_units_tbl,
                      i64 tbl_size) {
    memset(x, 0, sizeof *x);
    x->core = core;
    x->code = code;
    x->nmask = nmask;
    x->translated = translated;
    x->L = L;
    x->minimum_length = min_len_tbl;
    x->perfect_units = perf_units_tbl;
    x->tbl_size = tbl_size;
}

/* The requests of n pending items (seed_start, seed_end, motif length,
 * overlay channel).  Returns a RibbitRound to free with
 * ribbit_round_free. */
RibbitRound *ribbit_round_requests(RibbitCore *core, const int8_t *code,
                                   const uint8_t *nmask,
                                   const int8_t *translated, i64 L,
                                   const i64 *min_len_tbl,
                                   const i64 *perf_units_tbl, i64 tbl_size,
                                   i64 n, const i64 *seed_start,
                                   const i64 *seed_end, const i64 *mlen,
                                   const i64 *midx, i32 nthreads) {
    refine_entry_init();
    ReqPool p;
    memset(&p, 0, sizeof p);
    round_ctx(&p.x, core, code, nmask, translated, L, min_len_tbl,
              perf_units_tbl, tbl_size);
    p.n = n;
    p.s = seed_start;
    p.e = seed_end;
    p.m = mlen;
    p.midx = midx;
    p.nchunks = (n + ROUND_CHUNK - 1) / ROUND_CHUNK;
    p.chunks = (ReqChunk *)xcalloc((size_t)p.nchunks, sizeof(ReqChunk));
    run_pool(req_worker, &p, resolve_nthreads(nthreads), p.nchunks);

    RibbitRound *r = (RibbitRound *)xcalloc(1, sizeof(RibbitRound));
    i64 nread = 0, nref = 0;
    for (i64 c = 0; c < p.nchunks; c++) {
        r->n += p.chunks[c].n;
        nread += p.chunks[c].nread;
        nref += p.chunks[c].nref;
    }
    i64 **f[6] = {&r->item, &r->cand, &r->a_start, &r->a_len, &r->atom,
                  &r->unit};
    for (int j = 0; j < 6; j++)
        *f[j] = (i64 *)xmalloc((size_t)r->n * sizeof(i64));
    r->read_off = (i64 *)xmalloc((size_t)(r->n + 1) * sizeof(i64));
    r->ref_off = (i64 *)xmalloc((size_t)(r->n + 1) * sizeof(i64));
    r->reads = (int8_t *)xmalloc((size_t)nread);
    r->refs = (int8_t *)xmalloc((size_t)nref);
    i64 k = 0, ro = 0, fo = 0;
    r->read_off[0] = r->ref_off[0] = 0;
    for (i64 c = 0; c < p.nchunks; c++) {
        ReqChunk *q = &p.chunks[c];
        for (int j = 0; j < 6; j++) {
            if (q->n)
                memcpy(*f[j] + k, q->f[j], (size_t)q->n * sizeof(i64));
            free(q->f[j]);
        }
        for (i64 i = 0; i < q->n; i++) {
            r->read_off[k + i + 1] = r->read_off[k + i] + q->read_len[i];
            r->ref_off[k + i + 1] = r->ref_off[k + i] + q->ref_len[i];
        }
        if (q->nread) memcpy(r->reads + ro, q->reads, (size_t)q->nread);
        if (q->nref) memcpy(r->refs + fo, q->refs, (size_t)q->nref);
        k += q->n;
        ro += q->nread;
        fo += q->nref;
        free(q->read_len);
        free(q->ref_len);
        free(q->reads);
        free(q->refs);
    }
    free(p.chunks);
    return r;
}

void ribbit_round_free(RibbitRound *r) {
    if (!r) return;
    free(r->item); free(r->cand); free(r->a_start); free(r->a_len);
    free(r->atom); free(r->unit); free(r->read_off); free(r->ref_off);
    free(r->reads); free(r->refs);
    free(r);
}

/* ------------------------------------------------------------------ */
/* emission                                                           */
/* ------------------------------------------------------------------ */

/* One round's output: nlines BED lines (text, each ending in '\n'; line j
 * from request line_req[j]) and the next round's npend items, the flank
 * recursion's children: [p_start[j], p_end[j]) of request p_req[j]'s item
 * (its motif length, seed type and channel), child number p_child[j]. */
typedef struct {
    char *text;
    i64 text_len, nlines, npend;
    i64 *line_req;
    i64 *p_start, *p_end, *p_req, *p_child;
} RibbitEmit;

typedef struct {                /* one chunk's emission */
    StrBuf out;
    i64 nlines, lcap, np, pcap;
    i64 *line_req;
    i64 *pf[4];                 /* p_start, p_end, p_req, p_child */
} EmitChunk;

static void em_pend(EmitChunk *o, i64 s, i64 e, i64 req, i64 child) {
    if (o->np == o->pcap) {
        o->pcap = o->pcap ? 2 * o->pcap : 8;
        for (int j = 0; j < 4; j++)
            o->pf[j] = (i64 *)xrealloc(o->pf[j],
                                       (size_t)o->pcap * sizeof(i64));
    }
    i64 v[4] = {s, e, req, child};
    for (int j = 0; j < 4; j++) o->pf[j][o->np] = v[j];
    o->np++;
}

static void em_line(RefineCtx *x, EmitChunk *o, i64 req, i64 start, i64 end,
                    const char *motif, i64 atom, i64 m, float purity,
                    i64 seed_type, const char *cigar) {
    if (o->nlines == o->lcap) {
        o->lcap = o->lcap ? 2 * o->lcap : 16;
        o->line_req = (i64 *)xrealloc(o->line_req,
                                      (size_t)o->lcap * sizeof(i64));
    }
    o->line_req[o->nlines++] = req;
    emit_line(x, start, end, motif, atom, m, end - start,
              (end - start) / atom, purity, seed_type, cigar);
}

typedef struct {
    RefineCtx x;                /* read-only: each thread copies it */
    const RibbitRound *r;
    const i64 *s, *e, *m, *seed_type;
    const char *cigar;
    const i64 *cigar_off, *cigar_len;
    EmitChunk *chunks;
    i64 nchunks;
    i64 next;                   /* the next chunk to take (atomic) */
} EmitPool;

typedef struct { char *d; i64 cap; } Scratch;

static char *scratch(Scratch *b, i64 n) {
    if (n > b->cap) {
        b->cap = 2 * n;
        b->d = (char *)xrealloc(b->d, (size_t)b->cap);
    }
    return b->d;
}

/* request k after its alignment: the tail of process_seed_motifwise
 * (small) or of process_seed (large), its flank recursion included;
 * lines go to x->out */
static void round_emit_one(const EmitPool *p, RefineCtx *x, i64 k,
                           EmitChunk *o, Scratch *cb, Scratch *mb) {
    const RibbitRound *r = p->r;
    i64 len = p->cigar_len[k];
    if (len <= 0) return;       /* no alignment, or an empty cigar */
    char *cig = scratch(cb, len + 1);
    memcpy(cig, p->cigar + p->cigar_off[k], (size_t)len);
    cig[len] = 0;
    i64 it = r->item[k], m = p->m[it], atom = r->atom[k];
    i64 seed_start = p->s[it], seed_end = p->e[it], st = p->seed_type[it];
    char *motif = scratch(mb, atom + 1);
    const int8_t *ref = r->refs + r->ref_off[k];
    for (i64 i = 0; i < atom; i++) motif[i] = BASE_CHARS[ref[i]];
    motif[atom] = 0;
    if (r->cand[k] >= 0) {
        CigarResult cr = process_cigar_motifwise(r->a_start[k], r->a_len[k],
                                                 cig, atom);
        i64 rl = cr.repeat_end - cr.repeat_start;
        i64 mu = calculate_motif_units(x, cr.repeat_start, rl, atom,
                                       (uint64_t)r->unit[k]);
        if (mu >= perfect_units_of(x, atom) && rl >= min_length_of(x, atom))
            em_line(x, o, k, cr.repeat_start, cr.repeat_end, motif, atom, m,
                    cr.purity, st, cr.cigar);
        free(cr.cigar);
        return;
    }
    CigarResult cr = process_cigar_with_pruning(
        r->a_start[k], r->a_len[k], cig, atom, x->minimum_length,
        x->tbl_size);
    i64 first = cr.repeat_start, second = cr.repeat_end - atom;
    if (cr.alignment_length >= min_length_of(x, atom) &&
        cr.repeat_end - cr.repeat_start >= min_length_of(x, m))
        em_line(x, o, k, cr.repeat_start, cr.repeat_end, motif, atom, m,
                cr.purity, st, cr.cigar);
    free(cr.cigar);

    /* recursion into uncovered flanks (process_seed's tail): the children
     * in the order process_seed recurses into them */
    i64 flank_start = seed_start, child = 0;
    if (flank_start >= first) {
        flank_start = second;
    } else {
        if (first - flank_start >= min_length_of(x, m)) {
            if (flank_start < seed_start) flank_start = seed_start;
            if (first > seed_end) first = seed_end;
            if (!(flank_start == seed_start && first == seed_end))
                em_pend(o, flank_start, first, k, child++);
        }
        flank_start = second;
    }
    if (seed_end - flank_start >= min_length_of(x, m)) {
        if (flank_start < seed_start) flank_start = seed_start;
        if (flank_start != seed_start)
            em_pend(o, flank_start, seed_end, k, child);
    }
}

static void *emit_worker(void *arg) {
    EmitPool *p = (EmitPool *)arg;
    Scratch cb = {NULL, 0}, mb = {NULL, 0};
    for (;;) {
        i64 c = __atomic_fetch_add(&p->next, 1, __ATOMIC_RELAXED);
        if (c >= p->nchunks) break;
        RefineCtx x = p->x;
        x.out = &p->chunks[c].out;
        i64 n = p->r->n;
        i64 hi = (c + 1) * ROUND_CHUNK < n ? (c + 1) * ROUND_CHUNK : n;
        for (i64 k = c * ROUND_CHUNK; k < hi; k++)
            round_emit_one(p, &x, k, &p->chunks[c], &cb, &mb);
    }
    free(cb.d);
    free(mb.d);
    return NULL;
}

/* The BED lines and the next round's items of round r's requests, given
 * each request's cigar: cigar[cigar_off[k]:cigar_off[k] + cigar_len[k]]
 * (length 0: no alignment, or an empty cigar; the request then makes
 * nothing).  The item arrays are the ones r was made from; code and
 * nmask those of r's session, seq_id the BED's first column.  Returns a
 * RibbitEmit to free with ribbit_emit_free. */
RibbitEmit *ribbit_round_emit(const RibbitRound *r, const int8_t *code,
                              const uint8_t *nmask, i64 L,
                              const i64 *min_len_tbl,
                              const i64 *perf_units_tbl, i64 tbl_size,
                              const char *seq_id, const i64 *seed_start,
                              const i64 *seed_end, const i64 *mlen,
                              const i64 *seed_type, const char *cigar,
                              const i64 *cigar_off, const i64 *cigar_len,
                              i32 nthreads) {
    refine_entry_init();
    EmitPool p;
    memset(&p, 0, sizeof p);
    round_ctx(&p.x, NULL, code, nmask, NULL, L, min_len_tbl,
              perf_units_tbl, tbl_size);
    p.x.seq_id = seq_id;
    p.x.seq_id_len = (i64)strlen(seq_id);
    p.r = r;
    p.s = seed_start;
    p.e = seed_end;
    p.m = mlen;
    p.seed_type = seed_type;
    p.cigar = cigar;
    p.cigar_off = cigar_off;
    p.cigar_len = cigar_len;
    p.nchunks = (r->n + ROUND_CHUNK - 1) / ROUND_CHUNK;
    p.chunks = (EmitChunk *)xcalloc((size_t)p.nchunks, sizeof(EmitChunk));
    run_pool(emit_worker, &p, resolve_nthreads(nthreads), p.nchunks);

    RibbitEmit *em = (RibbitEmit *)xcalloc(1, sizeof(RibbitEmit));
    for (i64 c = 0; c < p.nchunks; c++) {
        em->text_len += p.chunks[c].out.n;
        em->nlines += p.chunks[c].nlines;
        em->npend += p.chunks[c].np;
    }
    em->text = (char *)xmalloc((size_t)em->text_len + 1);
    em->line_req = (i64 *)xmalloc((size_t)em->nlines * sizeof(i64));
    i64 **pf[4] = {&em->p_start, &em->p_end, &em->p_req, &em->p_child};
    for (int j = 0; j < 4; j++)
        *pf[j] = (i64 *)xmalloc((size_t)em->npend * sizeof(i64));
    i64 t = 0, nl = 0, np = 0;
    for (i64 c = 0; c < p.nchunks; c++) {
        EmitChunk *o = &p.chunks[c];
        if (o->out.n) memcpy(em->text + t, o->out.d, (size_t)o->out.n);
        if (o->nlines)
            memcpy(em->line_req + nl, o->line_req,
                   (size_t)o->nlines * sizeof(i64));
        for (int j = 0; j < 4; j++) {
            if (o->np)
                memcpy(*pf[j] + np, o->pf[j], (size_t)o->np * sizeof(i64));
            free(o->pf[j]);
        }
        t += o->out.n;
        nl += o->nlines;
        np += o->np;
        free(o->out.d);
        free(o->line_req);
    }
    em->text[t] = 0;
    free(p.chunks);
    return em;
}

void ribbit_emit_free(RibbitEmit *em) {
    if (!em) return;
    free(em->text); free(em->line_req);
    free(em->p_start); free(em->p_end); free(em->p_req); free(em->p_child);
    free(em);
}
