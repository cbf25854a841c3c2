// Native hot loops for the host collator (ruart_tpu_torch/data/collate.py).
//
// The collator's cost on a 1-core host is pure CPython iteration: walking
// ~150k small Python ints per batch-256 out of ragged per-candidate lists
// into fixed [R, L] arrays, hashing candidate rows for the dedup table,
// and identity-probing aliased id lists. The reference framework keeps its
// data loader in Python/torch workers (`Utils/VQA_Dataset.py:448-517`);
// here the ragged->fixed packing is a C extension consuming the Python
// item dicts directly (CPython C API + buffer protocol; every function is
// a drop-in for a vectorized-numpy equivalent kept as fallback and parity
// oracle in collate.py).
//
// All entry points hold the GIL (they touch PyObjects); the win is ~10-50x
// less interpreter dispatch, not parallelism. Output buffers are
// caller-allocated numpy arrays passed via the writable buffer protocol
// ("w*"), so no numpy C API dependency exists.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>

namespace {

// item[key] for dicts (the common case) or any mapping. Borrowed reference.
inline PyObject* get_key(PyObject* item, PyObject* key) {
  if (PyDict_Check(item)) {
    return PyDict_GetItemWithError(item, key);
  }
  // non-dict mapping: PyObject_GetItem returns a NEW reference; callers of
  // get_key expect borrowed, so this path leaks-by-design is not OK — treat
  // non-dicts as an error and let the Python fallback handle them.
  PyErr_SetString(PyExc_TypeError, "item is not a dict");
  return nullptr;
}

// fill_ids(items, key, vals_w*, lens_w*, L) -> None
//
// vals: zeroed int32 [R * L]; lens: int64 [R]. For each item, copies
// min(len(item[key]), L) values; exact match for collate.fill_ids /
// _pad_ids semantics (truncate, left-align, zero pad).
PyObject* fill_ids(PyObject*, PyObject* args) {
  PyObject* items;
  PyObject* key;
  Py_buffer vals, lens;
  Py_ssize_t L;
  if (!PyArg_ParseTuple(args, "O!Uw*w*n", &PyList_Type, &items, &key, &vals,
                        &lens, &L)) {
    return nullptr;
  }
  const Py_ssize_t R = PyList_GET_SIZE(items);
  bool ok = true;
  if (vals.len < (Py_ssize_t)(R * L * sizeof(int32_t)) ||
      lens.len < (Py_ssize_t)(R * sizeof(int64_t))) {
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    ok = false;
  }
  auto* v = static_cast<int32_t*>(vals.buf);
  auto* n = static_cast<int64_t*>(lens.buf);
  for (Py_ssize_t i = 0; ok && i < R; i++) {
    PyObject* seq = get_key(PyList_GET_ITEM(items, i), key);
    if (!seq) {
      if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, key);
      ok = false;
      break;
    }
    PyObject* fast = PySequence_Fast(seq, "id row is not a sequence");
    if (!fast) {
      ok = false;
      break;
    }
    Py_ssize_t m = PySequence_Fast_GET_SIZE(fast);
    if (m > L) m = L;
    n[i] = m;
    PyObject** e = PySequence_Fast_ITEMS(fast);
    int32_t* row = v + i * L;
    for (Py_ssize_t j = 0; j < m; j++) {
      long x = PyLong_AsLong(e[j]);
      if (x == -1 && PyErr_Occurred()) {
        ok = false;
        break;
      }
      if (x != (long)(int32_t)x) {  // np.fromiter(np.int32) would raise
        PyErr_SetString(PyExc_OverflowError, "id out of int32 range");
        ok = false;
        break;
      }
      row[j] = (int32_t)x;
    }
    Py_DECREF(fast);
  }
  PyBuffer_Release(&vals);
  PyBuffer_Release(&lens);
  if (!ok) return nullptr;
  Py_RETURN_NONE;
}

// pad_rows(rows, vals_w*, lens_w*, L) -> None  — fill_ids over a list of
// sequences instead of a list of dicts (collate._pad_ids semantics).
PyObject* pad_rows(PyObject*, PyObject* args) {
  PyObject* rows;
  Py_buffer vals, lens;
  Py_ssize_t L;
  if (!PyArg_ParseTuple(args, "O!w*w*n", &PyList_Type, &rows, &vals, &lens,
                        &L)) {
    return nullptr;
  }
  const Py_ssize_t R = PyList_GET_SIZE(rows);
  bool ok = true;
  if (vals.len < (Py_ssize_t)(R * L * sizeof(int32_t)) ||
      lens.len < (Py_ssize_t)(R * sizeof(int64_t))) {
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    ok = false;
  }
  auto* v = static_cast<int32_t*>(vals.buf);
  auto* n = static_cast<int64_t*>(lens.buf);
  for (Py_ssize_t i = 0; ok && i < R; i++) {
    PyObject* fast =
        PySequence_Fast(PyList_GET_ITEM(rows, i), "row is not a sequence");
    if (!fast) {
      ok = false;
      break;
    }
    Py_ssize_t m = PySequence_Fast_GET_SIZE(fast);
    if (m > L) m = L;
    n[i] = m;
    PyObject** e = PySequence_Fast_ITEMS(fast);
    int32_t* row = v + i * L;
    for (Py_ssize_t j = 0; j < m; j++) {
      long x = PyLong_AsLong(e[j]);
      if (x == -1 && PyErr_Occurred()) {
        ok = false;
        break;
      }
      if (x != (long)(int32_t)x) {  // np.fromiter(np.int32) would raise
        PyErr_SetString(PyExc_OverflowError, "id out of int32 range");
        ok = false;
        break;
      }
      row[j] = (int32_t)x;
    }
    Py_DECREF(fast);
  }
  PyBuffer_Release(&vals);
  PyBuffer_Release(&lens);
  if (!ok) return nullptr;
  Py_RETURN_NONE;
}

// fill_f32(items, key, vals_w*, width) -> None
//
// vals: zeroed float32 [R * width]; copies min(len, width) values per item
// (float32 cast == np.fromiter(..., np.float32) round-to-nearest).
PyObject* fill_f32(PyObject*, PyObject* args) {
  PyObject* items;
  PyObject* key;
  Py_buffer vals;
  Py_ssize_t W;
  if (!PyArg_ParseTuple(args, "O!Uw*n", &PyList_Type, &items, &key, &vals,
                        &W)) {
    return nullptr;
  }
  const Py_ssize_t R = PyList_GET_SIZE(items);
  bool ok = true;
  if (vals.len < (Py_ssize_t)(R * W * sizeof(float))) {
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    ok = false;
  }
  auto* v = static_cast<float*>(vals.buf);
  for (Py_ssize_t i = 0; ok && i < R; i++) {
    PyObject* seq = get_key(PyList_GET_ITEM(items, i), key);
    if (!seq) {
      if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, key);
      ok = false;
      break;
    }
    PyObject* fast = PySequence_Fast(seq, "row is not a sequence");
    if (!fast) {
      ok = false;
      break;
    }
    Py_ssize_t m = PySequence_Fast_GET_SIZE(fast);
    if (m > W) m = W;
    PyObject** e = PySequence_Fast_ITEMS(fast);
    float* row = v + i * W;
    for (Py_ssize_t j = 0; j < m; j++) {
      double x = PyFloat_AsDouble(e[j]);
      if (x == -1.0 && PyErr_Occurred()) {
        ok = false;
        break;
      }
      row[j] = (float)x;
    }
    Py_DECREF(fast);
  }
  PyBuffer_Release(&vals);
  if (!ok) return nullptr;
  Py_RETURN_NONE;
}

// fill_offsets(items, key, out_w*, counts_w*, max_words, max_bert) -> None
//
// out: zeroed int32 [R * max_words * 2]; counts: int64 [R]. Clips exactly
// like collate's offsets path: st = min(st, max_bert-1),
// ed = max(min(ed, max_bert), st).
PyObject* fill_offsets(PyObject*, PyObject* args) {
  PyObject* items;
  PyObject* key;
  Py_buffer out, counts;
  Py_ssize_t MW, MB;
  if (!PyArg_ParseTuple(args, "O!Uw*w*nn", &PyList_Type, &items, &key, &out,
                        &counts, &MW, &MB)) {
    return nullptr;
  }
  const Py_ssize_t R = PyList_GET_SIZE(items);
  bool ok = true;
  if (out.len < (Py_ssize_t)(R * MW * 2 * sizeof(int32_t)) ||
      counts.len < (Py_ssize_t)(R * sizeof(int64_t))) {
    PyErr_SetString(PyExc_ValueError, "output buffer too small");
    ok = false;
  }
  auto* o = static_cast<int32_t*>(out.buf);
  auto* c = static_cast<int64_t*>(counts.buf);
  for (Py_ssize_t i = 0; ok && i < R; i++) {
    PyObject* seq = get_key(PyList_GET_ITEM(items, i), key);
    if (!seq) {
      if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, key);
      ok = false;
      break;
    }
    PyObject* fast = PySequence_Fast(seq, "offsets row is not a sequence");
    if (!fast) {
      ok = false;
      break;
    }
    Py_ssize_t m = PySequence_Fast_GET_SIZE(fast);
    if (m > MW) m = MW;
    c[i] = m;
    PyObject** e = PySequence_Fast_ITEMS(fast);
    int32_t* row = o + i * MW * 2;
    for (Py_ssize_t j = 0; j < m; j++) {
      PyObject* pf = PySequence_Fast(e[j], "offset pair is not a sequence");
      if (!pf) {
        ok = false;
        break;
      }
      if (PySequence_Fast_GET_SIZE(pf) != 2) {
        PyErr_SetString(PyExc_ValueError, "offset pair length != 2");
        Py_DECREF(pf);
        ok = false;
        break;
      }
      PyObject** p = PySequence_Fast_ITEMS(pf);
      long st = PyLong_AsLong(p[0]);
      long ed = PyLong_AsLong(p[1]);
      Py_DECREF(pf);
      if ((st == -1 || ed == -1) && PyErr_Occurred()) {
        ok = false;
        break;
      }
      if (st > MB - 1) st = MB - 1;
      if (ed > MB) ed = MB;
      if (ed < st) ed = st;
      row[j * 2] = (int32_t)st;
      row[j * 2 + 1] = (int32_t)ed;
    }
    Py_DECREF(fast);
  }
  PyBuffer_Release(&out);
  PyBuffer_Release(&counts);
  if (!ok) return nullptr;
  Py_RETURN_NONE;
}

// unique_rows(flat_ro*, R, stride_bytes, inverse_w*, firsts_w*) -> n_unique
//
// Exact byte-equality unique in first-appearance order over R fixed-stride
// rows (same contract as collate.unique_rows): FNV-1a 64 open-addressing
// table with memcmp verification — no collision risk affects the result.
PyObject* unique_rows(PyObject*, PyObject* args) {
  Py_buffer flat;
  Py_buffer inverse, firsts;
  Py_ssize_t R, stride;
  if (!PyArg_ParseTuple(args, "y*nnw*w*", &flat, &R, &stride, &inverse,
                        &firsts)) {
    return nullptr;
  }
  bool ok = true;
  if (flat.len < R * stride ||
      inverse.len < (Py_ssize_t)(R * sizeof(int64_t)) ||
      firsts.len < (Py_ssize_t)(R * sizeof(int64_t))) {
    PyErr_SetString(PyExc_ValueError, "buffer too small");
    ok = false;
  }
  Py_ssize_t n_unique = 0;
  if (ok && R > 0) {
    // open addressing, power-of-two capacity >= 2R
    size_t cap = 16;
    while (cap < (size_t)(2 * R)) cap <<= 1;
    int64_t* slots = (int64_t*)PyMem_Malloc(cap * sizeof(int64_t));
    if (!slots) {
      PyErr_NoMemory();
      ok = false;
    } else {
      memset(slots, 0xff, cap * sizeof(int64_t));  // -1 = empty
      const auto* base = static_cast<const unsigned char*>(flat.buf);
      auto* inv = static_cast<int64_t*>(inverse.buf);
      auto* fst = static_cast<int64_t*>(firsts.buf);
      const size_t mask = cap - 1;
      for (Py_ssize_t i = 0; i < R; i++) {
        const unsigned char* row = base + i * stride;
        uint64_t h = 1469598103934665603ull;  // FNV-1a 64
        for (Py_ssize_t b = 0; b < stride; b++) {
          h ^= row[b];
          h *= 1099511628211ull;
        }
        size_t s = (size_t)h & mask;
        for (;;) {
          int64_t u = slots[s];
          if (u < 0) {
            slots[s] = n_unique;
            fst[n_unique] = i;
            inv[i] = n_unique;
            n_unique++;
            break;
          }
          if (memcmp(base + fst[u] * stride, row, stride) == 0) {
            inv[i] = u;
            break;
          }
          s = (s + 1) & mask;
        }
      }
      PyMem_Free(slots);
    }
  }
  PyBuffer_Release(&flat);
  PyBuffer_Release(&inverse);
  PyBuffer_Release(&firsts);
  if (!ok) return nullptr;
  return PyLong_FromSsize_t(n_unique);
}

// alias_all(items, k1, k2) -> bool : all(it[k1] is it[k2] for it in items)
PyObject* alias_all(PyObject*, PyObject* args) {
  PyObject* items;
  PyObject* k1;
  PyObject* k2;
  if (!PyArg_ParseTuple(args, "O!UU", &PyList_Type, &items, &k1, &k2)) {
    return nullptr;
  }
  const Py_ssize_t R = PyList_GET_SIZE(items);
  for (Py_ssize_t i = 0; i < R; i++) {
    PyObject* item = PyList_GET_ITEM(items, i);
    PyObject* a = get_key(item, k1);
    if (!a) {  // missing key raises, matching the python it[k] probe
      if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, k1);
      return nullptr;
    }
    PyObject* b = get_key(item, k2);
    if (!b) {
      if (!PyErr_Occurred()) PyErr_SetObject(PyExc_KeyError, k2);
      return nullptr;
    }
    if (a != b) Py_RETURN_FALSE;
  }
  Py_RETURN_TRUE;
}

PyMethodDef methods[] = {
    {"fill_ids", fill_ids, METH_VARARGS,
     "fill [R,L] int32 + [R] int64 lens from items[i][key] id lists"},
    {"pad_rows", pad_rows, METH_VARARGS,
     "fill [R,L] int32 + [R] int64 lens from a list of id lists"},
    {"fill_f32", fill_f32, METH_VARARGS,
     "fill [R,W] float32 from items[i][key] float lists"},
    {"fill_offsets", fill_offsets, METH_VARARGS,
     "fill [R,MW,2] int32 clipped offset pairs + [R] int64 counts"},
    {"unique_rows", unique_rows, METH_VARARGS,
     "first-appearance byte-exact unique over fixed-stride rows"},
    {"alias_all", alias_all, METH_VARARGS,
     "all(it[k1] is it[k2]) identity probe"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ruart_torch_fastcollate",
    "native collator hot loops", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__ruart_torch_fastcollate(void) {
  return PyModule_Create(&moduledef);
}
