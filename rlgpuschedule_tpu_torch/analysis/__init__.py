"""Runtime sentinels of the port (:mod:`.sentinels`). The JAX
package's static analyzer (jsan) waits for its slice (``ROADMAP.md``
queue 1, item 25)."""
from .sentinels import (CompileCounter, RecompileSentinelError,
                        assert_no_recompiles, intended_sync,
                        no_implicit_transfers, note_build)

__all__ = ["CompileCounter", "RecompileSentinelError",
           "assert_no_recompiles", "intended_sync", "no_implicit_transfers",
           "note_build"]
