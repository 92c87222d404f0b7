"""Serving-side runtime of the port: compressed-resident parameter
paging. The decode-on-demand :class:`~repro_torch.serve.paging.
PagedParamStore` keeps a ``.ceazs`` checkpoint stream as the resident
format and pages layers through the batched decode on first touch.
"""
from .paging import PagedParamStore, PinnedParams

__all__ = ["PagedParamStore", "PinnedParams"]
