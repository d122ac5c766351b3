/* Native batch JPEG decoder for the frame banks (a copy of the JAX package's
 * tpuhar/native/decode.c; the code below is unchanged).
 *
 * One clip is 16 JPEG decodes (tpuhar_torch/data/frames.py
 * FrameBankReader.read_clip); the cv2 path pays Python per-frame overhead
 * (imdecode call, ndarray wrap, BGR flip copy) on every frame and holds the GIL
 * between them.  This decoder takes the whole clip's encoded buffers in ONE
 * call, decodes straight into the caller's (F, H, W, 3) RGB array with
 * libjpeg(-turbo), and releases the GIL for the full batch (ctypes drops it
 * around the foreign call), with optional pthread fan-out across cores.
 *
 * Build (tpuhar_torch/native/__init__.py does this at first use):
 *   cc -O2 -shared -fPIC decode.c -o libtpuhar_decode.so -ljpeg -lpthread
 */
#include <setjmp.h>
#include <stddef.h>
#include <stdio.h> /* jpeglib.h needs FILE declared first */
#include <string.h>
#include <pthread.h>
#include <jpeglib.h>

typedef struct {
    struct jpeg_error_mgr mgr; /* must be first: cinfo->err points here */
    jmp_buf jb;
} err_t;

static void on_error(j_common_ptr cinfo) {
    err_t *e = (err_t *)cinfo->err;
    longjmp(e->jb, 1);
}

/* Decode one JPEG into out (H*W*3, RGB).
 * Returns 0 ok, 1 dimension/band mismatch, 2 decode error. */
static int decode_one(const unsigned char *buf, size_t len,
                      unsigned char *out, int H, int W) {
    struct jpeg_decompress_struct c;
    err_t e;
    c.err = jpeg_std_error(&e.mgr);
    e.mgr.error_exit = on_error;
    if (setjmp(e.jb)) {
        jpeg_destroy_decompress(&c);
        return 2;
    }
    jpeg_create_decompress(&c);
    jpeg_mem_src(&c, (unsigned char *)buf, (unsigned long)len);
    jpeg_read_header(&c, TRUE);
    c.out_color_space = JCS_RGB; /* bank JPEGs are standard color (frames.py) */
    jpeg_start_decompress(&c);
    if ((int)c.output_height != H || (int)c.output_width != W ||
        c.output_components != 3) {
        jpeg_abort_decompress(&c);
        jpeg_destroy_decompress(&c);
        return 1; /* caller falls back to the cv2 + resize path */
    }
    while (c.output_scanline < c.output_height) {
        JSAMPROW row = out + (size_t)c.output_scanline * W * 3;
        jpeg_read_scanlines(&c, &row, 1);
    }
    jpeg_finish_decompress(&c);
    jpeg_destroy_decompress(&c);
    return 0;
}

typedef struct {
    const unsigned char *blob; /* frame bank bytes */
    const long long *offs; /* per-image (offset, length); length<=0 = gap */
    const long long *lens;
    int n;
    unsigned char *out;
    int H, W;
    int start, step;
    int rc;
} job_t;

static void *worker(void *arg) {
    job_t *j = (job_t *)arg;
    size_t stride = (size_t)j->H * j->W * 3;
    for (int i = j->start; i < j->n; i += j->step) {
        if (j->lens[i] <= 0)
            continue; /* missing frame: caller pre-zeroed (black) */
        int r = decode_one(j->blob + j->offs[i], (size_t)j->lens[i],
                           j->out + stride * i, j->H, j->W);
        if (r && !j->rc)
            j->rc = r;
    }
    return NULL;
}

#define MAX_THREADS 64

/* Decode n images addressed as (offset, length) into one contiguous blob —
 * zero-copy from the mmapped/pread frame bank.  out must be n*H*W*3 bytes,
 * pre-zeroed if gaps should read as black.  Returns first nonzero rc. */
int tpuhar_decode_jpeg_bank(const unsigned char *blob, const long long *offs,
                            const long long *lens, int n, unsigned char *out,
                            int H, int W, int threads) {
    job_t jobs[MAX_THREADS];
    pthread_t tids[MAX_THREADS];
    if (threads < 1)
        threads = 1;
    if (threads > n)
        threads = n;
    if (threads > MAX_THREADS)
        threads = MAX_THREADS;
    if (threads == 1) {
        job_t j = {blob, offs, lens, n, out, H, W, 0, 1, 0};
        worker(&j);
        return j.rc;
    }
    int spawned[MAX_THREADS];
    for (int t = 0; t < threads; t++) {
        jobs[t] = (job_t){blob, offs, lens, n, out, H, W, t, threads, 0};
        spawned[t] = pthread_create(&tids[t], NULL, worker, &jobs[t]) == 0;
        if (!spawned[t])
            worker(&jobs[t]); /* EAGAIN etc.: run this shard inline */
    }
    int rc = 0;
    for (int t = 0; t < threads; t++) {
        if (spawned[t])
            pthread_join(tids[t], NULL);
        if (jobs[t].rc && !rc)
            rc = jobs[t].rc;
    }
    return rc;
}
