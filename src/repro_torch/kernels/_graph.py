"""What one call puts on the card, counted from a CUDA graph of it.

``kernels_of_one_call(fn)`` captures one call of ``fn`` in a CUDA graph and
walks the captured graph's nodes with the driver's graph API (``cuGraph*``
through ctypes on ``libcuda``; a ``cudaGraph_t`` is a ``CUgraph``). Each
kernel node names its function (``cuFuncGetName``, or ``cuKernelGetName``
where the node holds a library kernel); any other node (a memset, a copy)
is reported by its type. The count needs no profiler: it is what was
captured, not what a trace happened to record.
"""
from __future__ import annotations

import ctypes
import functools

import torch

_KERNEL_NODE = 0    # CU_GRAPH_NODE_TYPE_KERNEL
_NODE_TYPES = {1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty",
               6: "wait event", 7: "event record"}


class _KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 (cuda.h); the v1 struct is its prefix."""

    _fields_ = [("func", ctypes.c_void_p),
                *((f, ctypes.c_uint) for f in (
                    "gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                    "blockDimY", "blockDimZ", "sharedMemBytes")),
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


@functools.cache
def _driver() -> ctypes.CDLL:
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    for name in ("cuFuncGetName", "cuKernelGetName"):
        getattr(lib, name).argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                       ctypes.c_void_p]
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} failed: CUresult {err}")


def graph_nodes(graph: int) -> list:
    """[(node type, kernel name or None)] of a ``CUgraph`` handle, in the
    order the driver lists them."""
    lib = _driver()
    count = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(count)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    _check(lib.cuGraphGetNodes(graph, nodes, ctypes.byref(count)),
           "cuGraphGetNodes")
    get_params = getattr(lib, "cuGraphKernelNodeGetParams_v2", None) \
        or lib.cuGraphKernelNodeGetParams
    get_params.argtypes = [ctypes.c_void_p,
                           ctypes.POINTER(_KernelNodeParams)]
    out = []
    for node in nodes[:count.value]:
        kind = ctypes.c_int(-1)
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)),
               "cuGraphNodeGetType")
        if kind.value != _KERNEL_NODE:
            out.append((_NODE_TYPES.get(kind.value, str(kind.value)), None))
            continue
        params = _KernelNodeParams()
        _check(get_params(node, ctypes.byref(params)),
               "cuGraphKernelNodeGetParams")
        name = ctypes.c_char_p()
        if params.func:
            _check(lib.cuFuncGetName(ctypes.byref(name), params.func),
                   "cuFuncGetName")
        else:
            _check(lib.cuKernelGetName(ctypes.byref(name), params.kern),
                   "cuKernelGetName")
        out.append(("kernel", name.value.decode()))
    return out


def kernels_of_one_call(fn) -> tuple[list, list]:
    """(names of the CUDA kernels, types of the other nodes) that one call
    of ``fn`` puts into a CUDA graph. ``fn`` runs once first on a side
    stream, so that what a first call sets up (a library's build, the
    allocator's blocks) is not captured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    nodes = graph_nodes(graph.raw_cuda_graph())
    return ([name for kind, name in nodes if kind == "kernel"],
            [kind for kind, _ in nodes if kind != "kernel"])
