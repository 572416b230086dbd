"""Runtime preferences — reference prefs singleton (runtime/lib/prefs.cc):
a YAML config file layering defaults for log level, default batch size,
FIR method selection, and pallas gating.

Search order: $NEWSCHED_TPU_CONF, ./newsched_tpu.conf.yml,
~/.config/newsched_tpu/conf.yml. Env vars NEWSCHED_TPU_<KEY> override.

``yaml`` is imported only when a config file exists, so a machine without
PyYAML runs on the defaults and the environment overrides.
"""

from __future__ import annotations

import os
from typing import Any

_DEFAULTS: dict[str, Any] = {
    "log_level": "WARNING",
    "default_batch_size": 1 << 16,
    "fir_method": "auto",
    "use_pallas": False,
}

_cache: dict[str, Any] | None = None


def _load() -> dict[str, Any]:
    global _cache
    if _cache is not None:
        return _cache
    conf = dict(_DEFAULTS)
    paths = [
        os.environ.get("NEWSCHED_TPU_CONF"),
        os.path.join(os.getcwd(), "newsched_tpu.conf.yml"),
        os.path.expanduser("~/.config/newsched_tpu/conf.yml"),
    ]
    for p in paths:
        if p and os.path.exists(p):
            import yaml

            with open(p) as fh:
                loaded = yaml.safe_load(fh) or {}
            conf.update(loaded)
            break
    for key in list(conf):
        env = os.environ.get(f"NEWSCHED_TPU_{key.upper()}")
        if env is not None:
            cur = conf[key]
            if isinstance(cur, bool):
                conf[key] = env.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                conf[key] = int(env)
            else:
                conf[key] = env
    _cache = conf
    return conf


def get(key: str, default: Any = None) -> Any:
    return _load().get(key, default)


def reset_cache() -> None:
    global _cache
    _cache = None
