/* Fast host-side string column ingest/egress.
 *
 * Replaces the reference's host serialization loop
 * (cpp/src/strings/NVStringsImpl.cu:126-170) and the Python-level
 * encode/join fallback: one C pass flattens a list of Python strings into
 * (utf8 bytes, int32 offsets, validity) buffers ready for device upload,
 * and the reverse pass rebuilds Python strings from host buffers.
 *
 * Built as a plain CPython extension module (no pybind11; see
 * custrings/native/build.py).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <string.h>

/* flatten(list[str|None]) -> (bytes, offsets_bytes, validity_bytes) */
static PyObject *flatten(PyObject *self, PyObject *args) {
    PyObject *list;
    if (!PyArg_ParseTuple(args, "O", &list))
        return NULL;
    if (!PySequence_Check(list)) {
        PyErr_SetString(PyExc_TypeError, "expected a sequence");
        return NULL;
    }
    Py_ssize_t n = PySequence_Size(list);
    PyObject *fast = PySequence_Fast(list, "expected a sequence");
    if (!fast)
        return NULL;
    PyObject **items = PySequence_Fast_ITEMS(fast);

    /* first pass: measure */
    Py_ssize_t total = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = items[i];
        if (it == Py_None)
            continue;
        if (!PyUnicode_Check(it)) {
            Py_DECREF(fast);
            PyErr_SetString(PyExc_TypeError, "expected str or None");
            return NULL;
        }
        Py_ssize_t sz;
        const char *p = PyUnicode_AsUTF8AndSize(it, &sz);
        if (!p) {
            Py_DECREF(fast);
            return NULL;
        }
        total += sz;
    }
    if (total > 2147483647LL) {
        Py_DECREF(fast);
        PyErr_SetString(PyExc_OverflowError, "column exceeds int32 bytes");
        return NULL;
    }

    PyObject *data = PyBytes_FromStringAndSize(NULL, total);
    PyObject *offs = PyBytes_FromStringAndSize(NULL, (n + 1) * 4);
    PyObject *valid = PyBytes_FromStringAndSize(NULL, n);
    if (!data || !offs || !valid) {
        Py_XDECREF(data);
        Py_XDECREF(offs);
        Py_XDECREF(valid);
        Py_DECREF(fast);
        return NULL;
    }
    char *dp = PyBytes_AS_STRING(data);
    int32_t *op = (int32_t *)PyBytes_AS_STRING(offs);
    char *vp = PyBytes_AS_STRING(valid);

    Py_ssize_t pos = 0;
    op[0] = 0;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = items[i];
        if (it == Py_None) {
            vp[i] = 0;
        } else {
            vp[i] = 1;
            Py_ssize_t sz;
            const char *p = PyUnicode_AsUTF8AndSize(it, &sz);
            memcpy(dp + pos, p, sz);
            pos += sz;
        }
        op[i + 1] = (int32_t)pos;
    }
    Py_DECREF(fast);
    return Py_BuildValue("(NNN)", data, offs, valid);
}

/* unflatten(data_bytes, offsets_bytes, validity_bytes, n) -> list */
static PyObject *unflatten(PyObject *self, PyObject *args) {
    Py_buffer data, offs, valid;
    Py_ssize_t n;
    if (!PyArg_ParseTuple(args, "y*y*y*n", &data, &offs, &valid, &n))
        return NULL;
    const char *dp = (const char *)data.buf;
    const int32_t *op = (const int32_t *)offs.buf;
    const char *vp = (const char *)valid.buf;
    PyObject *out = NULL;
    /* Validate buffer shapes before decoding: inconsistent n or corrupt
     * offsets would otherwise read out of bounds in C. */
    if (n < 0 || offs.len < (Py_ssize_t)((n + 1) * sizeof(int32_t)) ||
        valid.len < n) {
        PyErr_SetString(PyExc_ValueError,
                        "unflatten: offsets/validity buffer too small for n");
        goto fail;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        if (op[i] < 0 || op[i] > op[i + 1] ||
            (Py_ssize_t)op[i + 1] > data.len) {
            PyErr_SetString(PyExc_ValueError,
                            "unflatten: offsets not monotone within data");
            goto fail;
        }
    }
    out = PyList_New(n);
    if (!out)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        if (!vp[i]) {
            Py_INCREF(Py_None);
            PyList_SET_ITEM(out, i, Py_None);
        } else {
            PyObject *s = PyUnicode_DecodeUTF8(
                dp + op[i], op[i + 1] - op[i], "strict");
            if (!s) {
                Py_DECREF(out);
                goto fail;
            }
            PyList_SET_ITEM(out, i, s);
        }
    }
    PyBuffer_Release(&data);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&valid);
    return out;
fail:
    PyBuffer_Release(&data);
    PyBuffer_Release(&offs);
    PyBuffer_Release(&valid);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"flatten", flatten, METH_VARARGS,
     "flatten(list[str|None]) -> (utf8 bytes, int32 offsets, validity)"},
    {"unflatten", unflatten, METH_VARARGS,
     "unflatten(data, offsets, validity, n) -> list[str|None]"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fastcolumn",
    "native string column flatten/unflatten", -1, Methods,
};

PyMODINIT_FUNC PyInit_fastcolumn(void) {
    return PyModule_Create(&moduledef);
}
