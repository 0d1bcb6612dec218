/* CPython extension: the host data-plane core of the port's ragged-batch
 * padding (di_hpc_tpu_torch.ops.padding, di_hpc_tpu_torch.data).
 *
 * The padded batch of host inputs is assembled on the host and then moved
 * to the device in one transfer, so the pack is a host loop; it lives in C
 * because its fixed cost per call is the per-array Python marshalling, not
 * the copies.  Through the buffer protocol (PyBUF_C_CONTIGUOUS) the loop
 * over the arrays has no Python work per array, and no numpy headers are
 * needed.
 *
 * Single entry point:
 *   pack_padded(list_of_arrays, out, mask, value) -> None
 *
 * - every element of `out` and `mask` is written exactly once (valid data,
 *   pad fill, and mask): callers pass np.empty, never np.full;
 * - every buffer must say it holds float32 (format "f"); a buffer without a
 *   format, a non-float32, non-contiguous or shape-mismatched input raises
 *   ValueError.  The Python side sends only contiguous float32 numpy
 *   arrays here and decides that before the call.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

#define MAX_NDIM 8

/* A buffer that names no format is unsigned bytes by the buffer protocol,
 * not float32: it is refused. */
static int is_f32(const Py_buffer *b) {
    return b->itemsize == 4 && b->format != NULL &&
           strcmp(b->format, "f") == 0;
}

static PyObject *
pack_padded(PyObject *self, PyObject *args)
{
    PyObject *seq_in, *out_obj, *mask_obj;
    Py_buffer outbuf = {0}, maskbuf = {0};
    double value_d;
    if (!PyArg_ParseTuple(args, "OOOd", &seq_in, &out_obj, &mask_obj,
                          &value_d))
        return NULL;
    const float value = (float)value_d;

    /* Full (shaped) writable buffers: "w*" in ParseTuple would hand back
     * SIMPLE buffers with ndim=1/shape=NULL. */
    const int wflags = PyBUF_C_CONTIGUOUS | PyBUF_FORMAT | PyBUF_WRITABLE;
    if (PyObject_GetBuffer(out_obj, &outbuf, wflags) != 0)
        return NULL;
    if (PyObject_GetBuffer(mask_obj, &maskbuf, wflags) != 0) {
        PyBuffer_Release(&outbuf);
        return NULL;
    }

    PyObject *seq = PySequence_Fast(seq_in, "pack_padded: expected a sequence");
    if (seq == NULL)
        goto fail_bufs;

    const Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    const int out_ndim = outbuf.ndim;
    int shapes_match = out_ndim >= 2 && maskbuf.ndim == out_ndim &&
                       outbuf.shape != NULL && maskbuf.shape != NULL;
    for (int d = 0; shapes_match && d < out_ndim; ++d)
        shapes_match = outbuf.shape[d] == maskbuf.shape[d];
    if (out_ndim < 2 || out_ndim > MAX_NDIM + 1 || !is_f32(&outbuf) ||
        !is_f32(&maskbuf) || !shapes_match || outbuf.shape == NULL ||
        outbuf.shape[0] != n) {
        PyErr_SetString(PyExc_ValueError,
                        "pack_padded: out/mask must be float32 (n, *max_shape) "
                        "with identical shapes");
        goto fail_seq;
    }
    const int ndim = out_ndim - 1;            /* per-sample rank */
    const Py_ssize_t *max_shape = outbuf.shape + 1;
    Py_ssize_t sample_sz = 1;
    for (int d = 0; d < ndim; ++d)
        sample_sz *= max_shape[d];
    const Py_ssize_t max_inner = max_shape[ndim - 1];
    Py_ssize_t max_outer = 1;
    for (int d = 0; d < ndim - 1; ++d)
        max_outer *= max_shape[d];

    for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject *item = PySequence_Fast_GET_ITEM(seq, i);
        Py_buffer src;
        if (PyObject_GetBuffer(item, &src,
                               PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) != 0)
            goto fail_seq;
        if (!is_f32(&src) || src.ndim != ndim || src.shape == NULL) {
            PyBuffer_Release(&src);
            PyErr_SetString(PyExc_ValueError,
                            "pack_padded: inputs must be contiguous float32 "
                            "of matching rank");
            goto fail_seq;
        }
        int fits = 1;
        for (int d = 0; d < ndim; ++d)
            fits = fits && src.shape[d] <= max_shape[d];
        if (!fits) {
            PyBuffer_Release(&src);
            PyErr_SetString(PyExc_ValueError,
                            "pack_padded: input exceeds max_shape");
            goto fail_seq;
        }
        const Py_ssize_t inner = src.shape[ndim - 1];
        const float *sp = (const float *)src.buf;
        float *dst = (float *)outbuf.buf + i * sample_sz;
        float *msk = (float *)maskbuf.buf + i * sample_sz;
        /* Walk all outer index tuples of the PADDED block in row-major
         * order, writing each padded row in one pass: valid prefix memcpy
         * + tail fill inside the source extent, full-row fill outside.
         * Row-major order over the padded box restricted to the source
         * sub-box preserves source row order, so src advances linearly. */
        Py_ssize_t idx[MAX_NDIM] = {0};
        Py_ssize_t src_off = 0;
        for (Py_ssize_t o = 0; o < max_outer; ++o) {
            float *drow = dst + o * max_inner;
            float *mrow = msk + o * max_inner;
            int in_src = 1;
            for (int d = 0; d < ndim - 1; ++d)
                in_src = in_src && idx[d] < src.shape[d];
            Py_ssize_t k = 0;
            if (in_src) {
                memcpy(drow, sp + src_off, inner * sizeof(float));
                src_off += inner;
                for (; k < inner; ++k)
                    mrow[k] = 1.0f;
            }
            for (; k < max_inner; ++k) {
                drow[k] = value;
                mrow[k] = value;
            }
            for (int d = ndim - 2; d >= 0; --d) {
                if (++idx[d] < max_shape[d])
                    break;
                idx[d] = 0;
            }
        }
        PyBuffer_Release(&src);
    }

    Py_DECREF(seq);
    PyBuffer_Release(&outbuf);
    PyBuffer_Release(&maskbuf);
    Py_RETURN_NONE;

fail_seq:
    Py_DECREF(seq);
fail_bufs:
    PyBuffer_Release(&outbuf);
    PyBuffer_Release(&maskbuf);
    return NULL;
}

static PyMethodDef HostcoreMethods[] = {
    {"pack_padded", pack_padded, METH_VARARGS,
     "pack_padded(arrays, out, mask, value): single-touch ragged pack of "
     "float32 arrays into preallocated (n, *max_shape) out/mask buffers."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef hostcore_module = {
    PyModuleDef_HEAD_INIT, "_dihpc_torch_hostcore",
    "Host data-plane core of di_hpc_tpu_torch (ragged padding pack).", -1,
    HostcoreMethods,
};

PyMODINIT_FUNC
PyInit__dihpc_torch_hostcore(void)
{
    return PyModule_Create(&hostcore_module);
}
