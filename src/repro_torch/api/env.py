"""The `REPRO_*` environment knobs — resolved ONCE at import.

Every runtime knob the port reads from the environment lives here, so
serving and tuning configuration has a single source of truth (and a
single place to audit).  Each knob is parsed exactly as the JAX package
parses it; nothing reads ``os.environ`` per call.

Stdlib only: kernels, models and the session import this at module scope.

Knobs, and where the port honours them:

``REPRO_KV_CACHE``      serving KV cache default ("auto" -> paged for
                        attention archs; "full" / "paged" force it):
                        `api.session.KV_CACHE_DEFAULT`
``REPRO_KV_DTYPE``      paged-pool value dtype ("bf16" exact / "int8"):
                        `api.session.KV_DTYPE_DEFAULT`
``REPRO_KV_UPDATE``     full-cache update strategy ("scatter" / "select"):
                        `models.kvcache.update`
``REPRO_AUTOTUNE``      "0" / "false" switches the kernel autotuner off:
                        `kernels.tune.enabled`
``REPRO_TUNE_BLOCK_ROWS``  "1" turns on the encode-time block_rows search:
                        `api.compress`
``REPRO_BF16_PSUM``     "1" rounds a raw projection's product to bf16
                        before its bias: `models.layers`
``REPRO_PALLAS_INTERPRET``  parsed for parity with the JAX package; the
                        port has no interpret mode and reads it nowhere
"""
from __future__ import annotations

import os
from typing import Optional

KV_CACHE: str = os.environ.get("REPRO_KV_CACHE", "auto")
KV_DTYPE: str = os.environ.get("REPRO_KV_DTYPE", "bf16")
KV_UPDATE: str = os.environ.get("REPRO_KV_UPDATE", "scatter")
AUTOTUNE: bool = os.environ.get("REPRO_AUTOTUNE", "1") not in ("0", "false")
TUNE_BLOCK_ROWS: bool = os.environ.get("REPRO_TUNE_BLOCK_ROWS") == "1"
BF16_PSUM: bool = os.environ.get("REPRO_BF16_PSUM") == "1"
#: the JAX package's Pallas interpret override (None = unset)
PALLAS_INTERPRET: Optional[bool] = (
    None if (_pi := os.environ.get("REPRO_PALLAS_INTERPRET")) is None
    else _pi not in ("0", "false", "False"))
