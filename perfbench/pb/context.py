"""One run's settings and its shared services, handed to the mix's driver."""
from __future__ import annotations

import dataclasses
import sys
from typing import Optional

from .spans import Spans


@dataclasses.dataclass
class Ctx:
    torch: object
    device: object              # torch.device the program runs on
    cell: str
    cfg: dict                   # configs/<config>.json
    mix: dict                   # mixes/<traffic>.json
    data: dict                  # cells/<cell>.json
    seed: int
    seconds: float
    trace: bool
    t_start: float              # perf_counter at process start
    dtype: Optional[str] = None  # factor dtype other than the config's
    spans: Spans = None

    def __post_init__(self):
        if self.spans is None:
            self.spans = Spans(sync=self.sync)

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def memory_peak(self) -> int:
        if self.device.type == "cuda":
            return int(self.torch.cuda.max_memory_allocated(self.device))
        return 0

    def settle(self) -> None:
        """Before the window: collect the set-up's garbage and move what
        survives out of the collector's later passes, so a collection in
        the window walks only what the window made."""
        import gc
        gc.collect()
        gc.freeze()

    def free(self) -> None:
        import gc
        gc.unfreeze()
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    @staticmethod
    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
