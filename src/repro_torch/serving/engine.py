"""Deprecated alias for :mod:`repro_torch.serving.decode` -- will be removed.

Port of ``repro.serving.engine``.  This module historically held the
local LM decode path under a name that collided with the distributed
:class:`repro_torch.serving.ServingEngine` (``server.py``) -- two
unrelated things both called "engine".  The decode path lives in
:mod:`repro_torch.serving.decode`; this shim re-exports it unchanged but
warns on import.  Import ``repro_torch.serving.decode`` (LM
prefill/decode) or ``repro_torch.serving`` (the distributed
ServingEngine) instead.
"""
import warnings

from repro_torch.serving.decode import (decode_step, extend_cache,
                                        greedy_generate, prefill)

warnings.warn(
    "repro_torch.serving.engine is a deprecated alias; import "
    "repro_torch.serving.decode instead",
    DeprecationWarning, stacklevel=2)

__all__ = ["decode_step", "extend_cache", "greedy_generate", "prefill"]
