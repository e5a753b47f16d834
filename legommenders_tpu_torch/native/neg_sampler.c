/* Fast host-side negative sampling for the training batch pipeline.
 *
 * The port's copy of the JAX package's native/neg_sampler.c. Replaces the
 * numpy argsort-based sampler (data/pipeline.py
 * TrainBatcher._sample_negatives): for each row, draw up to K true
 * negatives WITHOUT replacement from the user's negative list (partial
 * Fisher-Yates over the valid prefix, O(K) instead of O(M log M)), then
 * top up with uniform-random item ids — the reference's semantics
 * (resampler.py:159-171).
 *
 * Build: cc -O3 -shared -fPIC neg_sampler.c -o libnegsampler.so (done by
 * native/__init__.py into legommenders_tpu_torch/_build/ at first use)
 */
#include <stdint.h>
#include <string.h>

#define UNSET (-1)

/* xorshift128+ per-call PRNG: deterministic given seed */
typedef struct { uint64_t s0, s1; } rng_t;

static inline uint64_t rng_next(rng_t *r) {
    uint64_t x = r->s0, y = r->s1;
    r->s0 = y;
    x ^= x << 23;
    r->s1 = x ^ y ^ (x >> 17) ^ (y >> 26);
    return r->s1 + y;
}

static inline uint32_t rng_below(rng_t *r, uint32_t bound) {
    return (uint32_t)(rng_next(r) % (uint64_t)bound);
}

static void rng_seed(rng_t *r, uint64_t seed) {
    r->s0 = seed * 0x9E3779B97F4A7C15ULL + 1;
    r->s1 = (seed ^ 0xDEADBEEFCAFEBABEULL) * 0xBF58476D1CE4E5B9ULL + 1;
    for (int i = 0; i < 8; i++) rng_next(r);
}

/* negs: (U, M) int32, UNSET-padded; counts: (U,) int32; users: (B,) int64
 * out: (B, K) int32 */
void sample_negatives(const int32_t *negs, const int32_t *counts,
                      const int64_t *users, int64_t B, int64_t M,
                      int64_t K, int64_t num_items, uint64_t seed,
                      int32_t *out, int32_t *scratch /* size M */) {
    rng_t rng;
    rng_seed(&rng, seed);
    for (int64_t b = 0; b < B; b++) {
        const int64_t u = users[b];
        const int32_t *row = negs + u * M;
        int32_t cnt = counts[u];
        int64_t take = cnt < K ? cnt : K;
        /* partial Fisher-Yates over the valid prefix */
        memcpy(scratch, row, (size_t)cnt * sizeof(int32_t));
        for (int64_t j = 0; j < take; j++) {
            uint32_t pick = j + rng_below(&rng, (uint32_t)(cnt - j));
            int32_t tmp = scratch[j];
            scratch[j] = scratch[pick];
            scratch[pick] = tmp;
            out[b * K + j] = scratch[j];
        }
        for (int64_t j = take; j < K; j++)
            out[b * K + j] = (int32_t)rng_below(&rng, (uint32_t)num_items);
    }
}
