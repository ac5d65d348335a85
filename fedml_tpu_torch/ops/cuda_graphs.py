"""The nodes of a captured CUDA graph, read through libcuda.

``LAUNCHES`` counts launches where a wrapper makes them, in Python, so the
replays of a captured graph never count.  What a graph holds is read from
the graph itself: ``graph_nodes`` lists each node's kind (CUDA's
``CUgraphNodeType``) and, for a kernel node, the kernel's (mangled) name,
so a report can count the nodes of each kernel.  It needs a graph captured
with ``torch.cuda.CUDAGraph(keep_graph=True)``, and ``libcuda`` of CUDA
12.3 or later (``cuFuncGetName``).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

#: the kinds of a graph's nodes (CUDA's CUgraphNodeType)
NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host",
              4: "graph", 5: "empty", 6: "wait event", 7: "event record",
              10: "mem alloc", 11: "mem free"}


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2``."""

    _fields_ = [("func", ctypes.c_void_p),
                ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3),
                ("shared_mem_bytes", ctypes.c_uint),
                ("kernel_params", ctypes.c_void_p),
                ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p),
                ("ctx", ctypes.c_void_p)]


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUresult {rc}")


_libcuda: List[ctypes.CDLL] = []


def _cu() -> ctypes.CDLL:
    """``libcuda``, its entries typed (a round's graph has ~290k nodes:
    the calls are made once a node)."""
    if not _libcuda:
        cu = ctypes.CDLL("libcuda.so.1")
        vp = ctypes.c_void_p
        cu.cuGraphGetNodes.argtypes = [vp, vp, vp]
        cu.cuGraphNodeGetType.argtypes = [vp, vp]
        cu.cuGraphKernelNodeGetParams_v2.argtypes = [vp, vp]
        cu.cuFuncGetName.argtypes = [vp, vp]
        cu.cuKernelGetName.argtypes = [vp, vp]
        _libcuda.append(cu)
    return _libcuda[0]


def graph_nodes(graph: torch.cuda.CUDAGraph) -> List[Tuple[str, str]]:
    """``(kind, kernel name)`` of every node of ``graph`` (the name empty
    for nodes that are not kernels)."""
    cu = _cu()
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    _check(cu.cuGraphGetNodes(handle, None, ctypes.byref(count)),
           "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(count.value, 1))()
    _check(cu.cuGraphGetNodes(handle, nodes, ctypes.byref(count)),
           "cuGraphGetNodes")
    kind, params, name = ctypes.c_int(), _KernelNodeParams(), ctypes.c_char_p()
    kind_ref, params_ref, name_ref = (ctypes.byref(kind),
                                      ctypes.byref(params),
                                      ctypes.byref(name))
    get_type = cu.cuGraphNodeGetType
    get_params = cu.cuGraphKernelNodeGetParams_v2
    names = {}       # kernel names by function handle: nodes share them
    out = []
    for node in nodes[:count.value]:
        _check(get_type(node, kind_ref), "cuGraphNodeGetType")
        if kind.value != 0:
            out.append((NODE_KINDS.get(kind.value, str(kind.value)), ""))
            continue
        _check(get_params(node, params_ref), "cuGraphKernelNodeGetParams")
        key = (params.func, params.kern)
        if key not in names:
            if params.func:
                _check(cu.cuFuncGetName(name_ref, params.func),
                       "cuFuncGetName")
            else:
                _check(cu.cuKernelGetName(name_ref, params.kern),
                       "cuKernelGetName")
            names[key] = name.value.decode() if name.value else ""
        out.append(("kernel", names[key]))
    return out
