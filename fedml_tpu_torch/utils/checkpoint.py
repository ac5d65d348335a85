"""Round-level checkpoint and resume.

Port of ``fedml_tpu/utils/checkpoint.py::RoundCheckpointer`` in the JAX
package's fallback format, the one it writes without orbax: a file
``round_<round_idx:08d>.ckpt`` per round holding ``dumps_pytree(state)``
(``utils/serialization.py``), written to ``<file>.tmp`` and moved into
place with ``os.replace``, so a crash leaves either the old file or the
new one.  The newest ``keep`` files stay.  ``state`` is any tree the
serializer takes; the Parrot rounds save ``{"round_idx", "global_vars",
"server_state"}``, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

from .serialization import dumps_pytree, loads_pytree

_SUFFIX = ".ckpt"


class RoundCheckpointer:
    def __init__(self, ckpt_dir: str, keep: int = 3) -> None:
        if int(keep) < 1:
            raise ValueError(f"keep must be at least 1, not {keep}")
        self.dir = str(ckpt_dir)
        self.keep = int(keep)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, round_idx: int) -> str:
        return os.path.join(self.dir, f"round_{int(round_idx):08d}{_SUFFIX}")

    def _files(self) -> List[str]:
        return sorted(f for f in os.listdir(self.dir)
                      if f.startswith("round_") and f.endswith(_SUFFIX))

    def save(self, round_idx: int, state: Dict[str, Any],
             force: bool = False) -> None:
        """Write round ``round_idx``'s state.  A round already saved is
        refused unless ``force`` (the JAX package's orbax path refuses it
        too), and then replaced atomically."""
        path = self._path(round_idx)
        if os.path.exists(path) and not force:
            raise ValueError(f"round {round_idx} already checkpointed; pass "
                             f"force=True to re-save it")
        with open(path + ".tmp", "wb") as f:
            f.write(dumps_pytree(state))
            f.flush()
            os.fsync(f.fileno())
        os.replace(path + ".tmp", path)
        for old in self._files()[:-self.keep]:
            os.remove(os.path.join(self.dir, old))

    def latest_round(self) -> Optional[int]:
        """The newest saved round, or None."""
        files = self._files()
        if not files:
            return None
        return int(files[-1][len("round_"):-len(_SUFFIX)])

    def restore(self, round_idx: Optional[int] = None
                ) -> Optional[Dict[str, Any]]:
        """Round ``round_idx``'s state (the newest by default), or None
        when there is none."""
        step = self.latest_round() if round_idx is None else int(round_idx)
        if step is None:
            return None
        path = self._path(step)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return loads_pytree(f.read())
