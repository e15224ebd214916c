from vattention_tpu_torch.benchmark.config.config import (
    ConfigParser, flat_to_runner_args)

__all__ = ["ConfigParser", "flat_to_runner_args"]
