"""Version-tolerant asyncio surface (same spirit as jax_compat).

`asyncio.timeout` landed in Python 3.11; the gateway hot paths are
written against it, but baked images can run 3.10. `async_timeout`
(already in the image as an aiohttp dependency — nothing installed)
implements the identical async-context-manager semantics there.
"""

from __future__ import annotations

try:  # Python >= 3.11
    from asyncio import timeout
except ImportError:  # pragma: no cover - depends on baked image
    from async_timeout import timeout

__all__ = ["timeout"]
