// mesoio — native trajectory/dump writer for meso_tpu_torch (the port's
// own copy of meso_tpu/native/mesoio.cpp, its module renamed _mesoio_torch
// so that both packages load in one process).
//
// The analog of the reference's C++ dump machinery (LAMMPS
// src/dump_*.cpp): the host-side IO path, tag-sorting and text/binary
// formatting of million-particle frames, belongs in native code (a Python
// formatter is ~50x slower).
//
// Exposed via the CPython C API (no pybind11 needed); arrays are passed
// through the buffer protocol as contiguous float32/int32 buffers.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Buf {
    Py_buffer view{};
    bool ok = false;
    ~Buf() { if (ok) PyBuffer_Release(&view); }
    bool get(PyObject* obj, const char* name, Py_ssize_t itemsize) {
        if (PyObject_GetBuffer(obj, &view, PyBUF_C_CONTIGUOUS) != 0) {
            return false;
        }
        ok = true;
        if (view.itemsize != itemsize) {
            PyErr_Format(PyExc_TypeError, "%s: wrong itemsize %zd", name,
                         view.itemsize);
            return false;
        }
        return true;
    }
    Py_ssize_t n() const { return view.len / view.itemsize; }
};

// write_lammpstrj(path, append, step, box_lo3, box_hi3, tag_i32, typ_i32,
//                 x_f32 (N,3), v_f32 (N,3), mask_u8)
PyObject* write_lammpstrj(PyObject*, PyObject* args) {
    const char* path;
    int append;
    long long step;
    double lo[3], hi[3];
    PyObject *tag_o, *typ_o, *x_o, *v_o, *mask_o;
    if (!PyArg_ParseTuple(args, "spL(ddd)(ddd)OOOOO", &path, &append, &step,
                          &lo[0], &lo[1], &lo[2], &hi[0], &hi[1], &hi[2],
                          &tag_o, &typ_o, &x_o, &v_o, &mask_o)) {
        return nullptr;
    }
    Buf tag, typ, x, v, mask;
    if (!tag.get(tag_o, "tag", 4) || !typ.get(typ_o, "typ", 4) ||
        !x.get(x_o, "x", 4) || !v.get(v_o, "v", 4) ||
        !mask.get(mask_o, "mask", 1)) {
        return nullptr;
    }
    const auto* tag_p = static_cast<const int32_t*>(tag.view.buf);
    const auto* typ_p = static_cast<const int32_t*>(typ.view.buf);
    const auto* x_p = static_cast<const float*>(x.view.buf);
    const auto* v_p = static_cast<const float*>(v.view.buf);
    const auto* m_p = static_cast<const uint8_t*>(mask.view.buf);
    const Py_ssize_t n_rows = tag.n();

    std::vector<int64_t> rows;
    rows.reserve(n_rows);
    for (Py_ssize_t i = 0; i < n_rows; ++i) {
        if (m_p[i]) rows.push_back(i);
    }
    std::sort(rows.begin(), rows.end(), [&](int64_t a, int64_t b) {
        return tag_p[a] < tag_p[b];
    });

    FILE* fh = nullptr;
    Py_BEGIN_ALLOW_THREADS
    fh = std::fopen(path, append ? "ab" : "wb");
    Py_END_ALLOW_THREADS
    if (!fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS
    std::fprintf(fh, "ITEM: TIMESTEP\n%lld\n", step);
    std::fprintf(fh, "ITEM: NUMBER OF ATOMS\n%zu\n", rows.size());
    std::fprintf(fh, "ITEM: BOX BOUNDS pp pp pp\n");
    for (int d = 0; d < 3; ++d) {
        std::fprintf(fh, "%.6f %.6f\n", lo[d], hi[d]);
    }
    std::fprintf(fh, "ITEM: ATOMS id type x y z vx vy vz\n");
    std::vector<char> iobuf(1 << 20);
    std::setvbuf(fh, iobuf.data(), _IOFBF, iobuf.size());
    for (int64_t r : rows) {
        std::fprintf(fh, "%d %d %.6f %.6f %.6f %.6f %.6f %.6f\n",
                     tag_p[r], typ_p[r] + 1,
                     x_p[3 * r], x_p[3 * r + 1], x_p[3 * r + 2],
                     v_p[3 * r], v_p[3 * r + 1], v_p[3 * r + 2]);
    }
    std::fclose(fh);
    Py_END_ALLOW_THREADS
    return PyLong_FromSize_t(rows.size());
}

// write_frame_bin(path, append, step, box_lo3, box_hi3, tag, typ, x, v, mask)
// Compact binary frame: header (magic, version, step, n, box) + per-field
// contiguous payload in tag order. ~6x smaller and ~100x faster than text.
PyObject* write_frame_bin(PyObject*, PyObject* args) {
    const char* path;
    int append;
    long long step;
    double lo[3], hi[3];
    PyObject *tag_o, *typ_o, *x_o, *v_o, *mask_o;
    if (!PyArg_ParseTuple(args, "spL(ddd)(ddd)OOOOO", &path, &append, &step,
                          &lo[0], &lo[1], &lo[2], &hi[0], &hi[1], &hi[2],
                          &tag_o, &typ_o, &x_o, &v_o, &mask_o)) {
        return nullptr;
    }
    Buf tag, typ, x, v, mask;
    if (!tag.get(tag_o, "tag", 4) || !typ.get(typ_o, "typ", 4) ||
        !x.get(x_o, "x", 4) || !v.get(v_o, "v", 4) ||
        !mask.get(mask_o, "mask", 1)) {
        return nullptr;
    }
    const auto* tag_p = static_cast<const int32_t*>(tag.view.buf);
    const auto* typ_p = static_cast<const int32_t*>(typ.view.buf);
    const auto* x_p = static_cast<const float*>(x.view.buf);
    const auto* v_p = static_cast<const float*>(v.view.buf);
    const auto* m_p = static_cast<const uint8_t*>(mask.view.buf);
    const Py_ssize_t n_rows = tag.n();

    std::vector<int64_t> rows;
    rows.reserve(n_rows);
    for (Py_ssize_t i = 0; i < n_rows; ++i) {
        if (m_p[i]) rows.push_back(i);
    }
    std::sort(rows.begin(), rows.end(), [&](int64_t a, int64_t b) {
        return tag_p[a] < tag_p[b];
    });
    const uint64_t n = rows.size();

    FILE* fh = std::fopen(path, append ? "ab" : "wb");
    if (!fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS
    const uint32_t magic = 0x4D45534F;  // "MESO"
    const uint32_t version = 1;
    const int64_t step64 = step;
    std::fwrite(&magic, 4, 1, fh);
    std::fwrite(&version, 4, 1, fh);
    std::fwrite(&step64, 8, 1, fh);
    std::fwrite(&n, 8, 1, fh);
    double box[6] = {lo[0], lo[1], lo[2], hi[0], hi[1], hi[2]};
    std::fwrite(box, 8, 6, fh);
    std::vector<int32_t> ibuf(n);
    std::vector<float> fbuf(3 * n);
    for (uint64_t r = 0; r < n; ++r) ibuf[r] = tag_p[rows[r]];
    std::fwrite(ibuf.data(), 4, n, fh);
    for (uint64_t r = 0; r < n; ++r) ibuf[r] = typ_p[rows[r]];
    std::fwrite(ibuf.data(), 4, n, fh);
    for (uint64_t r = 0; r < n; ++r) {
        std::memcpy(&fbuf[3 * r], &x_p[3 * rows[r]], 12);
    }
    std::fwrite(fbuf.data(), 4, 3 * n, fh);
    for (uint64_t r = 0; r < n; ++r) {
        std::memcpy(&fbuf[3 * r], &v_p[3 * rows[r]], 12);
    }
    std::fwrite(fbuf.data(), 4, 3 * n, fh);
    std::fclose(fh);
    Py_END_ALLOW_THREADS
    return PyLong_FromUnsignedLongLong(n);
}

// read_frames_bin(path) -> list of (step, n, box_lo, box_hi, tag_bytes,
//                                   typ_bytes, x_bytes, v_bytes)
PyObject* read_frames_bin(PyObject*, PyObject* args) {
    const char* path;
    if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
    FILE* fh = std::fopen(path, "rb");
    if (!fh) {
        PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
        return nullptr;
    }
    PyObject* frames = PyList_New(0);
    for (;;) {
        uint32_t magic = 0, version = 0;
        int64_t step = 0;
        uint64_t n = 0;
        double box[6];
        if (std::fread(&magic, 4, 1, fh) != 1) break;
        if (magic != 0x4D45534F || std::fread(&version, 4, 1, fh) != 1 ||
            std::fread(&step, 8, 1, fh) != 1 ||
            std::fread(&n, 8, 1, fh) != 1 ||
            std::fread(box, 8, 6, fh) != 6) {
            PyErr_SetString(PyExc_ValueError, "corrupt frame header");
            std::fclose(fh);
            Py_DECREF(frames);
            return nullptr;
        }
        PyObject* tag_b = PyBytes_FromStringAndSize(nullptr, 4 * n);
        PyObject* typ_b = PyBytes_FromStringAndSize(nullptr, 4 * n);
        PyObject* x_b = PyBytes_FromStringAndSize(nullptr, 12 * n);
        PyObject* v_b = PyBytes_FromStringAndSize(nullptr, 12 * n);
        bool ok = tag_b && typ_b && x_b && v_b &&
            std::fread(PyBytes_AS_STRING(tag_b), 1, 4 * n, fh) == 4 * n &&
            std::fread(PyBytes_AS_STRING(typ_b), 1, 4 * n, fh) == 4 * n &&
            std::fread(PyBytes_AS_STRING(x_b), 1, 12 * n, fh) == 12 * n &&
            std::fread(PyBytes_AS_STRING(v_b), 1, 12 * n, fh) == 12 * n;
        if (!ok) {
            Py_XDECREF(tag_b); Py_XDECREF(typ_b);
            Py_XDECREF(x_b); Py_XDECREF(v_b);
            PyErr_SetString(PyExc_ValueError, "truncated frame payload");
            std::fclose(fh);
            Py_DECREF(frames);
            return nullptr;
        }
        PyObject* rec = Py_BuildValue(
            "{s:L,s:K,s:(ddd),s:(ddd),s:N,s:N,s:N,s:N}",
            "step", (long long)step, "n", (unsigned long long)n,
            "box_lo", box[0], box[1], box[2],
            "box_hi", box[3], box[4], box[5],
            "tag", tag_b, "typ", typ_b, "x", x_b, "v", v_b);
        PyList_Append(frames, rec);
        Py_DECREF(rec);
    }
    std::fclose(fh);
    return frames;
}

PyMethodDef methods[] = {
    {"write_lammpstrj", write_lammpstrj, METH_VARARGS,
     "fast tag-sorted LAMMPS text dump"},
    {"write_frame_bin", write_frame_bin, METH_VARARGS,
     "compact binary trajectory frame"},
    {"read_frames_bin", read_frames_bin, METH_VARARGS,
     "read all binary frames"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_mesoio_torch",
                         "native meso_tpu_torch IO", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__mesoio_torch(void) {
    return PyModule_Create(&moduledef);
}
