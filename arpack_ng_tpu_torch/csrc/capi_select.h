/* Forced-include header (g++ -include) that builds the unchanged
 * native/src/capi.cc against this package's bridge.
 *
 * capi.cc imports its Python side by name ("arpack_ng_tpu.native_bridge",
 * through PyImport_ImportModule).  This header includes <Python.h> first
 * and replaces that one call by atpu_port_import, which maps that name to
 * "arpack_ng_tpu_torch.native_bridge" and passes every other name through,
 * so the library imports neither JAX nor arpack_ng_tpu.  Built by
 * arpack_ng_tpu_torch/native_capi.py. */
#ifndef ATPU_CAPI_SELECT_H
#define ATPU_CAPI_SELECT_H

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <string.h>

static inline PyObject *atpu_port_import(const char *name) {
  if (name && strcmp(name, "arpack_ng_tpu.native_bridge") == 0)
    name = "arpack_ng_tpu_torch.native_bridge";
  return (PyImport_ImportModule)(name);
}

#define PyImport_ImportModule(n) atpu_port_import(n)

#endif /* ATPU_CAPI_SELECT_H */
