/* The C core's scan cut into its phases, so that the port times each one
 * (ribbit_tpu_torch/core.py: CoreSession.scan, one span a phase).
 *
 * ribbit_core_scan (csrc/ribbit_core.c) runs event generation, the three
 * scans and the final merge in one call.  The phases and the state they
 * share are static in that file, so this file includes it whole
 * (unchanged) and the port's core library builds from this file in its
 * place (core.py): every symbol the core exported, ribbit_core_scan too,
 * is still there once.
 *
 *   ribbit_core_scan_phase(c, k), k = 0..4, called in order, does exactly
 *   what ribbit_core_scan does between its stage marks, on its batch
 *   branch (no seed stream):
 *     0  the allocator tuning, and generate_events unless events were
 *        injected (returns 0)
 *     1  run_perfect_scan on the raw matches (returns the perfect seeds)
 *     2  run_substitution_scan (returns its seeds)
 *     3  run_anchored_scan on the overlay (returns its seeds)
 *     4  final_merge, then the pages handed back (returns the seed count,
 *        what ribbit_core_scan returns)
 *   and -1 for any other k.
 *
 * With RIBBIT_CORE_TIMING set each phase prints ribbit_core_scan's stage
 * line and seed counts to stderr (and RIBBIT_CORE_MEM its memory lines),
 * as that function does.
 *
 * The packed overlay cache (ov_pack: a row of ceil(L / 64) uint64 words a
 * motif channel, bit p & 63 of word p >> 6 the overlay at p) is built by
 * host generation only.  With events injected, the anchored scan and
 * refinement recompute the overlay of every range they ask about, unless
 * the cache is filled from outside (the card's event pass stores the same
 * words, ribbit_tpu_torch/csrc/scan_events.cu):
 *
 *   ribbit_core_overlay_alloc(c, nrows, nwords) gives the session nrows
 *   rows of nwords words, each its own malloc (as ribbit_core_destroy
 *   frees them), for the caller to fill through ribbit_core_overlay_row
 *   before phase 3.  It keeps host generation's rule: no cache when L is
 *   past ribbit_core_overlay_cache_max(), RIBBIT_OVERLAY_CACHE_MAX or
 *   256 Mi bp (which the extraction reads too, so it keeps no words for a
 *   contig the session would decline).  Returns nrows, 0 when the rule
 *   declines, -1 for a row count other than nmotifs or a
 *   word count other than ceil(L / 64), -2 when out of memory; in all but
 *   the first ov_pack is left unset (a cache the session had is freed).
 *   ribbit_core_overlay_row(c, d) is row d of the cache, whoever built it,
 *   or NULL.
 */

#include "../../csrc/ribbit_core.c"

static void phase_tick(const char *label, const struct timespec *t0) {
    struct timespec t1;
    clock_gettime(CLOCK_MONOTONIC, &t1);
    fprintf(stderr, "[core] %-12s %.3fs\n", label,
            (double)(t1.tv_sec - t0->tv_sec)
            + 1e-9 * (t1.tv_nsec - t0->tv_nsec));
    if (getenv("RIBBIT_CORE_MEM")) print_rss(label);
}

static void print_event_mem(RibbitCore *c) {
    i64 bperf = 0, bq7 = 0, bsv = 0, brj = 0, bov = 0;
    for (i32 d = 0; d < c->nmotifs; d++) {
        if (c->perf_s) bperf += (c->perf_s[d].cap + c->perf_e[d].cap) * 4;
        if (c->q7_emis) bq7 += c->q7_emis[d].cap * (i64)sizeof(Emis);
        if (c->q6_sink) {
            bsv += c->q6_sink[d].sv.cap;
            brj += c->q6_sink[d].rj.cap;
        }
    }
    if (c->ov_pack) bov = (i64)c->nmotifs * c->ov_words * 8;
    fprintf(stderr, "[core] mem perf=%lldM q7=%lldM sv=%lldM rj=%lldM "
            "ov=%lldM seq=%lldM\n", (long long)(bperf >> 20),
            (long long)(bq7 >> 20), (long long)(bsv >> 20),
            (long long)(brj >> 20), (long long)(bov >> 20),
            (long long)(c->L >> 20));
}

static i64 live_seeds(RibbitCore *c) {
    return c->perfect.n + c->substut.n + c->anchored.n
        - failed_seeds(&c->perfect) - failed_seeds(&c->substut)
        - failed_seeds(&c->anchored);
}

i64 ribbit_core_scan_phase(RibbitCore *c, i32 k) {
    static int malloc_tuned = 0;
    const char *timing = getenv("RIBBIT_CORE_TIMING");
    struct timespec t0;
    if (timing) clock_gettime(CLOCK_MONOTONIC, &t0);
    switch (k) {
    case 0:
        if (!malloc_tuned) {
            mallopt(M_MMAP_THRESHOLD, 64 << 20);
            mallopt(M_TRIM_THRESHOLD, 64 << 20);
            malloc_tuned = 1;
        }
        if (!c->events_ready) generate_events(c);
        if (timing) phase_tick("generate", &t0);
        if (timing && getenv("RIBBIT_CORE_MEM")) print_event_mem(c);
        return 0;
    case 1:
        c->overlay_phase = 0;
        run_perfect_scan(c);
        if (timing) {
            fprintf(stderr, "[core] perfect seeds: %lld\n",
                    (long long)c->perfect.n);
            phase_tick("perfect", &t0);
        }
        return c->perfect.n;
    case 2:
        run_substitution_scan(c);
        if (timing) {
            fprintf(stderr, "[core] seeds considering substitutions: "
                    "%lld\n", (long long)(live_seeds(c)));
            phase_tick("substitution", &t0);
        }
        return c->substut.n;
    case 3:
        c->overlay_phase = 1;
        run_anchored_scan(c);
        if (timing) {
            fprintf(stderr, "[core] seeds considering indels: %lld\n",
                    (long long)live_seeds(c));
            phase_tick("anchored", &t0);
        }
        return c->anchored.n;
    case 4:
        c->final_seeds.n = 0;
        final_merge(c);
        if (timing) {
            fprintf(stderr, "[core] seeds processed for alignment: %lld\n",
                    (long long)c->final_seeds.n);
            phase_tick("merge", &t0);
        }
        malloc_trim(0);
        return c->final_seeds.n;
    default:
        return -1;
    }
}

/* host generation's limit (generate_events) */
i64 ribbit_core_overlay_cache_max(void) {
    const char *cache_env = getenv("RIBBIT_OVERLAY_CACHE_MAX");
    return cache_env ? atoll(cache_env) : (i64)256 << 20;
}

i64 ribbit_core_overlay_alloc(RibbitCore *c, i32 nrows, i64 nwords) {
    ribbit_core_drop_overlay(c);
    if (nrows != c->nmotifs || nwords != (c->L + 63) >> 6)
        return -1;
    if (c->L > ribbit_core_overlay_cache_max())
        return 0;
    c->ov_words = nwords;
    c->ov_pack = (uint64_t **)calloc((size_t)nrows, sizeof(uint64_t *));
    for (i32 d = 0; c->ov_pack && d < nrows; d++) {
        c->ov_pack[d] = (uint64_t *)malloc((size_t)nwords * 8);
        if (!c->ov_pack[d]) {
            ribbit_core_drop_overlay(c);
            return -2;
        }
        advise_huge(c->ov_pack[d], (size_t)nwords * 8);
    }
    return c->ov_pack ? nrows : -2;
}

uint64_t *ribbit_core_overlay_row(RibbitCore *c, i32 d) {
    if (!c->ov_pack || d < 0 || d >= c->nmotifs)
        return NULL;
    return c->ov_pack[d];
}
