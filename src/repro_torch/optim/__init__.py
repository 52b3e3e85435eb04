from repro_torch.optim.adamw import (AdamWConfig, AdamWState,  # noqa: F401
                                     apply_update, init_state)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
