"""Run-directory logging (port of qcpinn_tpu/utils/logger.py; utils/logger.py
in the reference): a timestamped directory per experiment, an
``output.log`` file sink, formatted printing, and a config dump with
credential masking (trainer/diffusion_hybrid_trainer.py:96-102)."""

from __future__ import annotations

import datetime
import json
import logging
import os
from typing import Optional


class Logging:
    def __init__(self, log_root: str = "runs", run_name: Optional[str] = None):
        stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
        name = f"{run_name}-{stamp}" if run_name else stamp
        self.output_dir = os.path.join(log_root, name)
        os.makedirs(self.output_dir, exist_ok=True)

        self._logger = logging.getLogger(f"qcpinn_torch.{self.output_dir}")
        self._logger.setLevel(logging.INFO)
        self._logger.propagate = False
        self._handler = logging.FileHandler(os.path.join(self.output_dir, "output.log"))
        self._handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        self._logger.addHandler(self._handler)

    def get_output_dir(self) -> str:
        return self.output_dir

    def print(self, *args, **kwargs) -> None:
        msg = " ".join(
            f"{a:.6f}" if isinstance(a, float) else str(a) for a in args
        )
        print(msg, **{k: v for k, v in kwargs.items() if k in ("end", "flush")})
        self._logger.info(msg)

    def dump_config(self, config, filename: str = "config.json") -> str:
        """Persist the run config with token-like fields masked
        (train_hybrid_qpinn.py:911-917)."""
        if hasattr(config, "masked_dict"):
            payload = config.masked_dict()
        else:
            payload = {
                k: ("***masked***" if "token" in str(k).lower() else v)
                for k, v in dict(config).items()
            }
        path = os.path.join(self.output_dir, filename)
        with open(path, "w") as f:
            json.dump(payload, f, indent=2, default=str)
        self.print(f"Config written to {path}")
        return path

    def close(self) -> None:
        """Close the ``output.log`` sink."""
        self._logger.removeHandler(self._handler)
        self._handler.close()


class NullLogging:
    """The ``Logging`` interface for a rank that writes nothing: in a
    data-parallel run only rank 0 keeps the run directory and prints."""

    output_dir = None

    def get_output_dir(self):
        return None

    def print(self, *args, **kwargs) -> None:
        pass

    def dump_config(self, config, filename: str = "config.json"):
        return None

    def close(self) -> None:
        pass
