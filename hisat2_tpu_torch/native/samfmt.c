/* Batch SAM line formatter for the array-native unpaired writer.
 *
 * Python (io/sam.py write_batch_raw) stays in charge of policy: it
 * classifies each read (unaligned / simple-unique / complex), builds the
 * MD strings and the per-read scalar columns, then hands the whole batch
 * here.  This renders one line per non-complex read into a strided
 * buffer (stride bytes per read, lengths returned) — the Python side
 * stitches the slices together with the complex reads' object-path lines
 * interleaved in read order.  Mirrors the reference's C++ sam.h role on
 * the output hot path.
 *
 * kind per read: 0 = unaligned, 4 = unaligned + YF:Z:NS,
 *                6 = unaligned + YF:Z:QC (--qc-filter),
 *                1 = simple unique, 3 = complex (skipped here).
 */
#include <stdint.h>
#include <string.h>
#include <stdio.h>

static inline char *put_str(char *p, const char *s, int n) {
    memcpy(p, s, n);
    return p + n;
}

static inline char *put_u(char *p, long v) {
    char tmp[24];
    int n = 0;
    if (v < 0) { *p++ = '-'; v = -v; }
    do { tmp[n++] = '0' + (v % 10); v /= 10; } while (v);
    while (n) *p++ = tmp[--n];
    return p;
}

#ifdef __cplusplus
extern "C"
#endif
int sam_render_batch(
    int64_t B, int64_t L, int64_t stride,
    const uint8_t *name_bytes, const int64_t *name_off,   /* [B+1] */
    const uint8_t *fw_ascii, const uint8_t *q_ascii,      /* [B, L] */
    const uint8_t *rc_ascii, const uint8_t *rq_ascii,     /* [B, L] */
    const int32_t *lens, const int8_t *kind, const int8_t *rc,
    const uint8_t *ref_bytes, const int64_t *ref_off,     /* per rid */
    const int32_t *rid, const int64_t *rpos1, const int32_t *mapq,
    const int32_t *clip_l, const int32_t *clip_r, const int32_t *score,
    const int8_t *has_zs, const int32_t *zs, const int8_t *xs_code,
    const int64_t *mm_off,                                /* [B+1] */
    const int32_t *mm_pos, const uint8_t *mm_ref,         /* ascii */
    int8_t no_unal,
    uint8_t *out, int32_t *out_len)
{
    for (int64_t i = 0; i < B; i++) {
        char *p0 = (char *)out + i * stride, *p = p0;
        int k = kind[i];
        if (k == 3) { out_len[i] = 0; continue; }
        int64_t Ln = lens[i];
        const uint8_t *nm_b = name_bytes + name_off[i];
        int nm_n = (int)(name_off[i + 1] - name_off[i]);
        if (k == 0 || k == 4 || k == 6) {
            if (no_unal) { out_len[i] = 0; continue; }
            p = put_str(p, (const char *)nm_b, nm_n);
            p = put_str(p, "\t4\t*\t0\t0\t*\t*\t0\t0\t", 17);
            p = put_str(p, (const char *)(fw_ascii + i * L), Ln);
            *p++ = '\t';
            p = put_str(p, (const char *)(q_ascii + i * L), Ln);
            p = put_str(p, "\tYT:Z:UU", 8);
            if (k == 4) p = put_str(p, "\tYF:Z:NS", 8);
            else if (k == 6) p = put_str(p, "\tYF:Z:QC", 8);
            *p++ = '\n';
            out_len[i] = (int32_t)(p - p0);
            continue;
        }
        /* simple unique alignment */
        p = put_str(p, (const char *)nm_b, nm_n);
        *p++ = '\t';
        p = put_u(p, rc[i] ? 16 : 0);
        *p++ = '\t';
        {
            const uint8_t *rb = ref_bytes + ref_off[rid[i]];
            int rn = (int)(ref_off[rid[i] + 1] - ref_off[rid[i]]);
            p = put_str(p, (const char *)rb, rn);
        }
        *p++ = '\t';
        p = put_u(p, rpos1[i]);
        *p++ = '\t';
        p = put_u(p, mapq[i]);
        *p++ = '\t';
        {
            int cl = clip_l[i], cr = clip_r[i];
            long mid = Ln - cl - cr;
            if (cl) { p = put_u(p, cl); *p++ = 'S'; }
            p = put_u(p, mid); *p++ = 'M';
            if (cr) { p = put_u(p, cr); *p++ = 'S'; }
        }
        p = put_str(p, "\t*\t0\t0\t", 7);
        p = put_str(p, (const char *)((rc[i] ? rc_ascii : fw_ascii)
                                      + i * L), Ln);
        *p++ = '\t';
        p = put_str(p, (const char *)((rc[i] ? rq_ascii : q_ascii)
                                      + i * L), Ln);
        p = put_str(p, "\tAS:i:", 6);
        p = put_u(p, score[i]);
        if (has_zs[i]) {
            p = put_str(p, "\tZS:i:", 6);
            p = put_u(p, zs[i]);
        }
        {
            long nm = mm_off[i + 1] - mm_off[i];
            long mid = Ln - clip_l[i] - clip_r[i];
            p = put_str(p, "\tXN:i:0\tXM:i:", 13);
            p = put_u(p, nm);
            p = put_str(p, "\tXO:i:0\tXG:i:0\tNM:i:", 20);
            p = put_u(p, nm);
            p = put_str(p, "\tMD:Z:", 6);
            long prev = -1;
            for (int64_t m = mm_off[i]; m < mm_off[i + 1]; m++) {
                p = put_u(p, mm_pos[m] - prev - 1);
                *p++ = (char)mm_ref[m];
                prev = mm_pos[m];
            }
            p = put_u(p, mid - prev - 1);
        }
        p = put_str(p, "\tYT:Z:UU", 8);
        if (xs_code[i] == 1) p = put_str(p, "\tXS:A:+", 7);
        else if (xs_code[i] == 2) p = put_str(p, "\tXS:A:-", 7);
        p = put_str(p, "\tNH:i:1\n", 8);
        out_len[i] = (int32_t)(p - p0);
    }
    return 0;
}
