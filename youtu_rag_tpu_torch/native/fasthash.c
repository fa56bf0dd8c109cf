/* Native feature-hash embedding kernel (host side).
 *
 * The device kernels make search fast; at 10M-chunk build scale the *host*
 * becomes the bottleneck — tokenize + hash + accumulate in Python runs
 * ~1M words/s on this box. This C implementation of the HashEmbedder hot
 * loop (same tokenization semantics: ASCII [A-Za-z0-9_]+ words lowercased,
 * CJK codepoints as single tokens, other symbols as single tokens) runs
 * the whole pipeline allocation-free per text.
 *
 * Hashing: FNV-1a 64-bit over the token bytes with a "feat:" domain
 * prefix, reduced mod dim — mirrored exactly by the Python fallback in
 * youtu_rag_tpu/models/embedder.py so both paths produce identical
 * vectors.
 *
 * Built via cffi at first import (gcc -O3); see native/__init__.py.
 */

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define FNV_OFFSET 14695981039346656037ULL
#define FNV_PRIME 1099511628211ULL

static uint64_t fnv1a_update(uint64_t h, const unsigned char *data, size_t n) {
    for (size_t i = 0; i < n; i++) {
        h ^= (uint64_t)data[i];
        h *= FNV_PRIME;
    }
    return h;
}

/* hash of "feat:" + token bytes */
static uint64_t feat_hash(const unsigned char *tok, size_t n) {
    static const unsigned char prefix[5] = {'f', 'e', 'a', 't', ':'};
    uint64_t h = fnv1a_update(FNV_OFFSET, prefix, 5);
    return fnv1a_update(h, tok, n);
}

static int is_word_byte(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') ||
           (c >= '0' && c <= '9') || c == '_';
}

/* decode one UTF-8 codepoint; returns bytes consumed (>=1) */
static int utf8_decode(const unsigned char *s, size_t n, uint32_t *cp) {
    unsigned char c = s[0];
    if (c < 0x80) { *cp = c; return 1; }
    if ((c >> 5) == 0x6 && n >= 2) { *cp = ((c & 0x1F) << 6) | (s[1] & 0x3F); return 2; }
    if ((c >> 4) == 0xE && n >= 3) {
        *cp = ((c & 0x0F) << 12) | ((s[1] & 0x3F) << 6) | (s[2] & 0x3F);
        return 3;
    }
    if ((c >> 3) == 0x1E && n >= 4) {
        *cp = ((c & 0x07) << 18) | ((s[1] & 0x3F) << 12) | ((s[2] & 0x3F) << 6) | (s[3] & 0x3F);
        return 4;
    }
    *cp = c; /* invalid byte: treat as itself */
    return 1;
}

#define MAX_TOKEN 64
#define TABLE_BITS 12 /* 4096-entry open-addressing tf table per text */
#define TABLE_SIZE (1 << TABLE_BITS)

static int is_uspace(uint32_t cp); /* defined with the tokenizer below */

typedef struct {
    uint64_t hash;
    int count;
} TfEntry;

/* embed one utf-8 text into out[dim]; returns token count */
int hash_embed_one(const char *text, int len, float *out, int dim) {
    TfEntry table[TABLE_SIZE];
    memset(table, 0, sizeof(table));
    const unsigned char *s = (const unsigned char *)text;
    size_t n = (size_t)len;
    size_t i = 0;
    unsigned char tok[MAX_TOKEN];
    int total = 0;

    while (i < n) {
        unsigned char c = s[i];
        size_t tlen = 0;
        if (is_word_byte(c)) {
            while (i < n && is_word_byte(s[i])) {
                if (tlen < MAX_TOKEN) {
                    unsigned char lc = s[i];
                    if (lc >= 'A' && lc <= 'Z') lc += 32;
                    tok[tlen++] = lc;
                }
                i++;
            }
        } else if (c < 0x80) {
            /* full Python \s ASCII subset incl. 0x1C-0x1F file separators */
            if (is_uspace((uint32_t)c)) {
                i++;
                continue;
            }
            tok[tlen++] = c; /* single ASCII symbol token */
            i++;
        } else {
            uint32_t cp;
            int used = utf8_decode(s + i, n - i, &cp);
            i += used;
            /* Python's \s is the UNICODE whitespace set: NBSP/ideographic
             * space/NEL must be skipped here too or native and Python
             * embeddings diverge on ordinary web/PDF text */
            if (is_uspace(cp)) continue;
            /* CJK or any non-ASCII codepoint: single-codepoint token,
             * mirroring the Python tokenizer's per-char handling */
            size_t copy = (size_t)used < MAX_TOKEN ? (size_t)used : MAX_TOKEN;
            memcpy(tok, s + i - (size_t)used, copy);
            tlen = copy;
        }
        if (tlen == 0) continue;
        uint64_t h = feat_hash(tok, tlen);
        /* open addressing */
        uint64_t slot = h & (TABLE_SIZE - 1);
        int inserted = 0;
        for (int probe = 0; probe < TABLE_SIZE; probe++) {
            TfEntry *e = &table[slot];
            if (e->count == 0) {
                e->hash = h;
                e->count = 1;
                inserted = 1;
                break;
            }
            if (e->hash == h) {
                e->count++;
                inserted = 1;
                break;
            }
            slot = (slot + 1) & (TABLE_SIZE - 1);
        }
        if (!inserted) {
            /* tf table full (>4096 distinct tokens): zero the output and
             * report failure so the caller re-embeds via the (unbounded)
             * Python path instead of silently dropping tokens */
            for (int d = 0; d < dim; d++) out[d] = 0.0f;
            return -1;
        }
        total++;
    }

    for (int d = 0; d < dim; d++) out[d] = 0.0f;
    double sumsq = 0.0;
    for (int t = 0; t < TABLE_SIZE; t++) {
        if (table[t].count == 0) continue;
        int idx = (int)(table[t].hash % (uint64_t)dim);
        float w = 1.0f + logf((float)table[t].count);
        out[idx] += w;
    }
    for (int d = 0; d < dim; d++) sumsq += (double)out[d] * out[d];
    if (sumsq > 0) {
        float inv = (float)(1.0 / sqrt(sumsq));
        for (int d = 0; d < dim; d++) out[d] *= inv;
    }
    return total;
}

/* batch entry point: texts concatenated with explicit offsets */
void hash_embed_batch(const char *buf, const int *offsets, int n_texts, float *out, int dim) {
    for (int t = 0; t < n_texts; t++) {
        int start = offsets[t];
        int end = offsets[t + 1];
        hash_embed_one(buf + start, end - start, out + (size_t)t * dim, dim);
    }
}

/* ----------------------------------------------------------------------
 * Encoder tokenizer fast path: word/codepoint tokenization + blake2b-8
 * token ids, exactly matching models/tokenizer.py HashTokenizer.tokenize
 * (which hashes with hashlib.blake2b(digest_size=8), little-endian
 * signed). Texts arrive already lowercased (Python str.lower() runs
 * host-side first so full-Unicode case folding stays correct).
 * -------------------------------------------------------------------- */

static const uint64_t B2B_IV[8] = {
    0x6a09e667f3bcc908ULL, 0xbb67ae8584caa73bULL, 0x3c6ef372fe94f82bULL,
    0xa54ff53a5f1d36f1ULL, 0x510e527fade682d1ULL, 0x9b05688c2b3e6c1fULL,
    0x1f83d9abfb41bd6bULL, 0x5be0cd19137e2179ULL};

static const unsigned char B2B_SIGMA[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};

static inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

#define B2B_G(a, b, c, d, x, y)                                                \
    do {                                                                       \
        v[a] = v[a] + v[b] + (x);                                              \
        v[d] = rotr64(v[d] ^ v[a], 32);                                        \
        v[c] = v[c] + v[d];                                                    \
        v[b] = rotr64(v[b] ^ v[c], 24);                                        \
        v[a] = v[a] + v[b] + (y);                                              \
        v[d] = rotr64(v[d] ^ v[a], 16);                                        \
        v[c] = v[c] + v[d];                                                    \
        v[b] = rotr64(v[b] ^ v[c], 63);                                        \
    } while (0)

static void b2b_compress(uint64_t h[8], const unsigned char block[128],
                         uint64_t t, int final) {
    uint64_t v[16], m[16];
    for (int i = 0; i < 8; i++) v[i] = h[i];
    for (int i = 0; i < 8; i++) v[i + 8] = B2B_IV[i];
    v[12] ^= t; /* t_hi always 0 at token scale */
    if (final) v[14] = ~v[14];
    for (int i = 0; i < 16; i++) {
        uint64_t w = 0;
        for (int j = 7; j >= 0; j--) w = (w << 8) | block[i * 8 + j];
        m[i] = w;
    }
    for (int r = 0; r < 12; r++) {
        const unsigned char *s = B2B_SIGMA[r % 10];
        B2B_G(0, 4, 8, 12, m[s[0]], m[s[1]]);
        B2B_G(1, 5, 9, 13, m[s[2]], m[s[3]]);
        B2B_G(2, 6, 10, 14, m[s[4]], m[s[5]]);
        B2B_G(3, 7, 11, 15, m[s[6]], m[s[7]]);
        B2B_G(0, 5, 10, 15, m[s[8]], m[s[9]]);
        B2B_G(1, 6, 11, 12, m[s[10]], m[s[11]]);
        B2B_G(2, 7, 8, 13, m[s[12]], m[s[13]]);
        B2B_G(3, 4, 9, 14, m[s[14]], m[s[15]]);
    }
    for (int i = 0; i < 8; i++) h[i] ^= v[i] ^ v[i + 8];
}

/* blake2b digest_size=8, unkeyed; returns h[0] (== the 8-byte digest read
 * little-endian, i.e. exactly Python's stable_hash64 as uint64) */
static uint64_t blake2b8(const unsigned char *data, size_t n) {
    uint64_t h[8];
    for (int i = 0; i < 8; i++) h[i] = B2B_IV[i];
    h[0] ^= 0x01010000ULL ^ 8ULL; /* digest_size=8, key=0, fanout=depth=1 */
    size_t off = 0;
    while (n - off > 128) {
        b2b_compress(h, data + off, (uint64_t)(off + 128), 0);
        off += 128;
    }
    unsigned char buf[128];
    memset(buf, 0, 128);
    memcpy(buf, data + off, n - off);
    b2b_compress(h, buf, (uint64_t)n, 1);
    return h[0];
}

/* Python regex \s whitespace set (unicode) */
static int is_uspace(uint32_t cp) {
    if (cp == ' ' || (cp >= 0x09 && cp <= 0x0D)) return 1;
    if (cp >= 0x1C && cp <= 0x1F) return 1;
    if (cp == 0x85 || cp == 0xA0 || cp == 0x1680) return 1;
    if (cp >= 0x2000 && cp <= 0x200A) return 1;
    if (cp == 0x2028 || cp == 0x2029 || cp == 0x202F || cp == 0x205F) return 1;
    return cp == 0x3000;
}

/* tokenize one pre-lowercased utf-8 text into hashed ids:
 * id = n_special + blake2b8(token) mod n_buckets (Python-modulo).
 * Returns the number of ids written (capped at max_out). */
int tokenize_ids(const char *text, int len, int32_t *out, int max_out,
                 int n_buckets, int n_special) {
    const unsigned char *s = (const unsigned char *)text;
    size_t n = (size_t)len, i = 0;
    int written = 0;
    while (i < n && written < max_out) {
        unsigned char c = s[i];
        const unsigned char *tok = s + i;
        size_t tlen = 0;
        if (is_word_byte(c)) {
            size_t start = i;
            while (i < n && is_word_byte(s[i])) i++;
            tlen = i - start;
        } else {
            uint32_t cp;
            int used = utf8_decode(s + i, n - i, &cp);
            i += (size_t)used;
            if (is_uspace(cp)) continue;
            tlen = (size_t)used; /* single-codepoint token */
        }
        int64_t hv = (int64_t)blake2b8(tok, tlen);
        int64_t m = hv % (int64_t)n_buckets;
        if (m < 0) m += n_buckets; /* Python modulo semantics */
        out[written++] = (int32_t)(n_special + m);
    }
    return written;
}

/* batch: texts concatenated (pre-lowercased) with explicit offsets;
 * per-text ids land at out + t*max_len, counts[t] = ids written */
void tokenize_ids_batch(const char *buf, const int *offsets, int n_texts,
                        int32_t *out, int *counts, int max_len,
                        int n_buckets, int n_special) {
    for (int t = 0; t < n_texts; t++) {
        counts[t] = tokenize_ids(buf + offsets[t], offsets[t + 1] - offsets[t],
                                 out + (size_t)t * max_len, max_len,
                                 n_buckets, n_special);
    }
}
