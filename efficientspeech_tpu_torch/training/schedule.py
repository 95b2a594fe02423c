"""Linear-warmup + cosine-decay learning rate over epochs, mapped to steps
(counterpart of the JAX package's ``training/schedule.py``).  At step 0 of
a warm-up the rate is 0."""

import math
from typing import Callable


def warmup_cosine_schedule(base_lr: float, warmup_epochs: int,
                           total_epochs: int, steps_per_epoch: int,
                           min_lr: float = 0.0) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        if epoch < warmup_epochs:
            return base_lr * epoch / max(1, warmup_epochs)
        progress = (epoch - warmup_epochs) / max(1, total_epochs
                                                 - warmup_epochs)
        return base_lr * max(min_lr, 0.5 * (1.0 + math.cos(math.pi
                                                           * progress)))

    return schedule
