"""Context re-export (``fedml_tpu/core/alg_frame/context.py``)."""

from .params import Context, Params

__all__ = ["Context", "Params"]
