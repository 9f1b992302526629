/* NAL emulation prevention (H.264 7.4.1): insert 0x03 after two zero
 * bytes that precede a byte <= 0x03. Copy of vt_escape_emulation from
 * vlog_tpu/native/cavlc.c, the only function of that file the CABAC
 * path needs. */

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

int64_t vt_escape_emulation(const uint8_t *in, int64_t n, uint8_t *out) {
    int64_t j = 0;
    int zeros = 0;
    for (int64_t i = 0; i < n; i++) {
        uint8_t b = in[i];
        if (zeros >= 2 && b <= 3) {
            out[j++] = 3;
            zeros = 0;
        }
        out[j++] = b;
        zeros = (b == 0) ? zeros + 1 : 0;
    }
    return j;
}

#ifdef __cplusplus
}
#endif
