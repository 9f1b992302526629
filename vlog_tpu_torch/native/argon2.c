/* Argon2id (RFC 9106, version 0x13) over BLAKE2b (RFC 7693).
 *
 * The worker-key hash of api/auth.py: the same function argon2-cffi
 * computes, so a PHC string minted by either side verifies in the other.
 * Lanes are filled one after another inside each slice (the result does
 * not depend on the order: a slice never references the blocks other
 * lanes write in the same slice).
 *
 *   int vt_argon2id(pwd, pwdlen, salt, saltlen, secret, secretlen,
 *                   ad, adlen, t_cost, m_cost_kib, lanes, out, outlen)
 *
 * returns 0, or -1 on bad parameters, -2 when the memory cannot be had.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---------------------------------------------------------------- BLAKE2b */

static const uint64_t B2_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const uint8_t B2_SIGMA[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

typedef struct {
    uint64_t h[8];
    uint64_t t[2];
    uint8_t buf[128];
    size_t buflen;
    size_t outlen;
} b2_state;

static uint64_t rotr64(uint64_t x, unsigned n) {
    return (x >> n) | (x << (64 - n));
}

static uint64_t load64(const uint8_t *p) {
    uint64_t v = 0;
    for (int i = 7; i >= 0; --i) v = (v << 8) | p[i];
    return v;
}

static void store64(uint8_t *p, uint64_t v) {
    for (int i = 0; i < 8; ++i) p[i] = (uint8_t)(v >> (8 * i));
}

static void store32(uint8_t *p, uint32_t v) {
    for (int i = 0; i < 4; ++i) p[i] = (uint8_t)(v >> (8 * i));
}

#define B2G(a, b, c, d, x, y)          \
    do {                               \
        a = a + b + (x);               \
        d = rotr64(d ^ a, 32);         \
        c = c + d;                     \
        b = rotr64(b ^ c, 24);         \
        a = a + b + (y);               \
        d = rotr64(d ^ a, 16);         \
        c = c + d;                     \
        b = rotr64(b ^ c, 63);         \
    } while (0)

static void b2_compress(b2_state *s, const uint8_t *block, int last) {
    uint64_t m[16], v[16];
    for (int i = 0; i < 16; ++i) m[i] = load64(block + 8 * i);
    for (int i = 0; i < 8; ++i) {
        v[i] = s->h[i];
        v[i + 8] = B2_IV[i];
    }
    v[12] ^= s->t[0];
    v[13] ^= s->t[1];
    if (last) v[14] = ~v[14];
    for (int r = 0; r < 12; ++r) {
        const uint8_t *sg = B2_SIGMA[r];
        B2G(v[0], v[4], v[8], v[12], m[sg[0]], m[sg[1]]);
        B2G(v[1], v[5], v[9], v[13], m[sg[2]], m[sg[3]]);
        B2G(v[2], v[6], v[10], v[14], m[sg[4]], m[sg[5]]);
        B2G(v[3], v[7], v[11], v[15], m[sg[6]], m[sg[7]]);
        B2G(v[0], v[5], v[10], v[15], m[sg[8]], m[sg[9]]);
        B2G(v[1], v[6], v[11], v[12], m[sg[10]], m[sg[11]]);
        B2G(v[2], v[7], v[8], v[13], m[sg[12]], m[sg[13]]);
        B2G(v[3], v[4], v[9], v[14], m[sg[14]], m[sg[15]]);
    }
    for (int i = 0; i < 8; ++i) s->h[i] ^= v[i] ^ v[i + 8];
}

static void b2_init(b2_state *s, size_t outlen) {
    memset(s, 0, sizeof(*s));
    for (int i = 0; i < 8; ++i) s->h[i] = B2_IV[i];
    s->h[0] ^= 0x01010000ULL ^ (uint64_t)outlen;   /* unkeyed, fanout 1 */
    s->outlen = outlen;
}

static void b2_count(b2_state *s, uint64_t n) {
    s->t[0] += n;
    if (s->t[0] < n) s->t[1]++;
}

static void b2_update(b2_state *s, const uint8_t *in, size_t n) {
    while (n > 0) {
        if (s->buflen == 128) {     /* more input follows: not the last */
            b2_count(s, 128);
            b2_compress(s, s->buf, 0);
            s->buflen = 0;
        }
        size_t take = 128 - s->buflen;
        if (take > n) take = n;
        memcpy(s->buf + s->buflen, in, take);
        s->buflen += take;
        in += take;
        n -= take;
    }
}

static void b2_final(b2_state *s, uint8_t *out) {
    uint8_t full[64];
    b2_count(s, s->buflen);
    memset(s->buf + s->buflen, 0, 128 - s->buflen);
    b2_compress(s, s->buf, 1);
    for (int i = 0; i < 8; ++i) store64(full + 8 * i, s->h[i]);
    memcpy(out, full, s->outlen);
}

static void b2(uint8_t *out, size_t outlen, const uint8_t *in, size_t n) {
    b2_state s;
    b2_init(&s, outlen);
    b2_update(&s, in, n);
    b2_final(&s, out);
}

/* H' of RFC 9106 section 3.3: a hash of any output length. */
static void b2_long(uint8_t *out, uint32_t outlen, const uint8_t *in,
                    size_t n) {
    uint8_t len[4], v[64], prev[64];
    b2_state s;
    store32(len, outlen);
    if (outlen <= 64) {
        b2_init(&s, outlen);
        b2_update(&s, len, 4);
        b2_update(&s, in, n);
        b2_final(&s, out);
        return;
    }
    b2_init(&s, 64);
    b2_update(&s, len, 4);
    b2_update(&s, in, n);
    b2_final(&s, v);
    memcpy(out, v, 32);
    out += 32;
    uint32_t left = outlen - 32;
    while (left > 64) {
        memcpy(prev, v, 64);
        b2(v, 64, prev, 64);
        memcpy(out, v, 32);
        out += 32;
        left -= 32;
    }
    memcpy(prev, v, 64);
    b2(v, left, prev, 64);
    memcpy(out, v, left);
}

/* ---------------------------------------------------------------- Argon2 */

#define QWORDS 128              /* one 1024-byte block */
#define SYNC_POINTS 4
#define ADDRESSES_IN_BLOCK 128

typedef struct { uint64_t v[QWORDS]; } block;

static uint64_t fBlaMka(uint64_t x, uint64_t y) {
    return x + y + 2 * (uint64_t)(uint32_t)x * (uint64_t)(uint32_t)y;
}

#define GB(a, b, c, d)                 \
    do {                               \
        a = fBlaMka(a, b);             \
        d = rotr64(d ^ a, 32);         \
        c = fBlaMka(c, d);             \
        b = rotr64(b ^ c, 24);         \
        a = fBlaMka(a, b);             \
        d = rotr64(d ^ a, 16);         \
        c = fBlaMka(c, d);             \
        b = rotr64(b ^ c, 63);         \
    } while (0)

#define ROUND(v0, v1, v2, v3, v4, v5, v6, v7, v8, v9, v10, v11, v12, v13,   \
              v14, v15)                                                     \
    do {                                                                    \
        GB(v0, v4, v8, v12);                                                \
        GB(v1, v5, v9, v13);                                                \
        GB(v2, v6, v10, v14);                                               \
        GB(v3, v7, v11, v15);                                               \
        GB(v0, v5, v10, v15);                                               \
        GB(v1, v6, v11, v12);                                               \
        GB(v2, v7, v8, v13);                                                \
        GB(v3, v4, v9, v14);                                                \
    } while (0)

/* next = G(prev, ref), XORed into next's old value when with_xor. */
static void fill_block(const block *prev, const block *ref, block *next,
                       int with_xor) {
    block r, tmp;
    for (int i = 0; i < QWORDS; ++i) r.v[i] = ref->v[i] ^ prev->v[i];
    tmp = r;
    if (with_xor)
        for (int i = 0; i < QWORDS; ++i) tmp.v[i] ^= next->v[i];
    uint64_t *v = r.v;
    for (int i = 0; i < 8; ++i)
        ROUND(v[16 * i], v[16 * i + 1], v[16 * i + 2], v[16 * i + 3],
              v[16 * i + 4], v[16 * i + 5], v[16 * i + 6], v[16 * i + 7],
              v[16 * i + 8], v[16 * i + 9], v[16 * i + 10], v[16 * i + 11],
              v[16 * i + 12], v[16 * i + 13], v[16 * i + 14],
              v[16 * i + 15]);
    for (int i = 0; i < 8; ++i)
        ROUND(v[2 * i], v[2 * i + 1], v[2 * i + 16], v[2 * i + 17],
              v[2 * i + 32], v[2 * i + 33], v[2 * i + 48], v[2 * i + 49],
              v[2 * i + 64], v[2 * i + 65], v[2 * i + 80], v[2 * i + 81],
              v[2 * i + 96], v[2 * i + 97], v[2 * i + 112],
              v[2 * i + 113]);
    for (int i = 0; i < QWORDS; ++i) next->v[i] = tmp.v[i] ^ r.v[i];
}

static void next_addresses(block *address, block *input, const block *zero) {
    input->v[6]++;
    fill_block(zero, input, address, 0);
    fill_block(zero, address, address, 0);
}

typedef struct {
    block *memory;
    uint32_t passes, lanes, lane_length, segment_length, memory_blocks;
} instance;

static uint32_t index_alpha(const instance *in, uint32_t pass, uint32_t slice,
                            uint32_t index, uint32_t pseudo_rand,
                            int same_lane) {
    uint32_t area;
    if (pass == 0) {
        if (slice == 0)
            area = index - 1;
        else if (same_lane)
            area = slice * in->segment_length + index - 1;
        else
            area = slice * in->segment_length + (index == 0 ? -1 : 0);
    } else {
        if (same_lane)
            area = in->lane_length - in->segment_length + index - 1;
        else
            area = in->lane_length - in->segment_length +
                   (index == 0 ? -1 : 0);
    }
    uint64_t rel = pseudo_rand;
    rel = (rel * rel) >> 32;
    rel = area - 1 - (((uint64_t)area * rel) >> 32);
    uint32_t start = 0;
    if (pass != 0)
        start = (slice == SYNC_POINTS - 1) ? 0 : (slice + 1) * in->segment_length;
    return (uint32_t)((start + rel) % in->lane_length);
}

static void fill_segment(const instance *in, uint32_t pass, uint32_t lane,
                         uint32_t slice) {
    block address, input, zero;
    int independent = (pass == 0 && slice < SYNC_POINTS / 2);  /* Argon2id */
    if (independent) {
        memset(&zero, 0, sizeof zero);
        memset(&input, 0, sizeof input);
        input.v[0] = pass;
        input.v[1] = lane;
        input.v[2] = slice;
        input.v[3] = in->memory_blocks;
        input.v[4] = in->passes;
        input.v[5] = 2;                                 /* Argon2id */
    }
    uint32_t start = 0;
    if (pass == 0 && slice == 0) {
        start = 2;
        if (independent) next_addresses(&address, &input, &zero);
    }
    uint32_t curr = lane * in->lane_length + slice * in->segment_length + start;
    uint32_t prev = (curr % in->lane_length == 0) ? curr + in->lane_length - 1
                                                  : curr - 1;
    for (uint32_t i = start; i < in->segment_length; ++i, ++curr, ++prev) {
        if (curr % in->lane_length == 1) prev = curr - 1;
        uint64_t pseudo;
        if (independent) {
            if (i % ADDRESSES_IN_BLOCK == 0)
                next_addresses(&address, &input, &zero);
            pseudo = address.v[i % ADDRESSES_IN_BLOCK];
        } else {
            pseudo = in->memory[prev].v[0];
        }
        uint32_t ref_lane = (uint32_t)((pseudo >> 32) % in->lanes);
        if (pass == 0 && slice == 0) ref_lane = lane;
        uint32_t ref_index = index_alpha(in, pass, slice, i,
                                         (uint32_t)(pseudo & 0xFFFFFFFFu),
                                         ref_lane == lane);
        const block *ref = in->memory + (uint64_t)in->lane_length * ref_lane
                           + ref_index;
        fill_block(in->memory + prev, ref, in->memory + curr, pass != 0);
    }
}

int vt_argon2id(const uint8_t *pwd, uint32_t pwdlen, const uint8_t *salt,
                uint32_t saltlen, const uint8_t *secret, uint32_t secretlen,
                const uint8_t *ad, uint32_t adlen, uint32_t t_cost,
                uint32_t m_cost, uint32_t lanes, uint8_t *out,
                uint32_t outlen) {
    if (t_cost < 1 || lanes < 1 || outlen < 4 || saltlen < 8 ||
        m_cost < 8 * lanes)
        return -1;
    instance in;
    in.lanes = lanes;
    in.passes = t_cost;
    in.memory_blocks = m_cost - m_cost % (SYNC_POINTS * lanes);
    in.segment_length = in.memory_blocks / (lanes * SYNC_POINTS);
    in.lane_length = in.segment_length * SYNC_POINTS;
    in.memory = (block *)malloc(sizeof(block) * (size_t)in.memory_blocks);
    if (in.memory == NULL) return -2;

    /* H0 */
    uint8_t h0[72], w[4];
    b2_state s;
    b2_init(&s, 64);
    uint32_t head[6] = {lanes, outlen, m_cost, t_cost, 0x13, 2};
    for (int i = 0; i < 6; ++i) {
        store32(w, head[i]);
        b2_update(&s, w, 4);
    }
    store32(w, pwdlen);
    b2_update(&s, w, 4);
    b2_update(&s, pwd, pwdlen);
    store32(w, saltlen);
    b2_update(&s, w, 4);
    b2_update(&s, salt, saltlen);
    store32(w, secretlen);
    b2_update(&s, w, 4);
    if (secretlen) b2_update(&s, secret, secretlen);
    store32(w, adlen);
    b2_update(&s, w, 4);
    if (adlen) b2_update(&s, ad, adlen);
    b2_final(&s, h0);

    /* the first two blocks of every lane */
    uint8_t bytes[1024];
    for (uint32_t l = 0; l < lanes; ++l) {
        for (uint32_t j = 0; j < 2; ++j) {
            store32(h0 + 64, j);
            store32(h0 + 68, l);
            b2_long(bytes, 1024, h0, 72);
            block *b = in.memory + (uint64_t)l * in.lane_length + j;
            for (int k = 0; k < QWORDS; ++k) b->v[k] = load64(bytes + 8 * k);
        }
    }

    for (uint32_t pass = 0; pass < t_cost; ++pass)
        for (uint32_t slice = 0; slice < SYNC_POINTS; ++slice)
            for (uint32_t l = 0; l < lanes; ++l)
                fill_segment(&in, pass, l, slice);

    /* XOR of the last block of every lane, then H' to the tag length */
    block final = in.memory[in.lane_length - 1];
    for (uint32_t l = 1; l < lanes; ++l) {
        const block *b = in.memory + (uint64_t)l * in.lane_length
                         + in.lane_length - 1;
        for (int k = 0; k < QWORDS; ++k) final.v[k] ^= b->v[k];
    }
    for (int k = 0; k < QWORDS; ++k) store64(bytes + 8 * k, final.v[k]);
    b2_long(out, outlen, bytes, 1024);
    memset(in.memory, 0, sizeof(block) * (size_t)in.memory_blocks);
    free(in.memory);
    return 0;
}
