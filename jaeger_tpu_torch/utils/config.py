"""Copy of `jaeger_tpu/utils/config.py`.

Jinja2-templated YAML config loading.

Parity target: reference ``utils/misc.py:66-114`` — configs may reference
their own fields (``{{ model.experiment }}``-style), resolved by rendering
the template against the parsed YAML and re-parsing (two passes so chained
references settle). ``seed: random`` draws a fresh seed. ``yaml`` and
``jinja2`` are imported inside the functions, so the model path imports
without them.
"""

from __future__ import annotations

import random
from pathlib import Path
from typing import Any


def load_model_config(path: str | Path, passes: int = 2) -> dict[str, Any]:
    import jinja2
    import yaml

    text = Path(path).read_text()
    config = yaml.safe_load(text)
    for _ in range(passes):
        rendered = jinja2.Template(text).render(**(config or {}))
        config = yaml.safe_load(rendered)
    model = config.get("model", {})
    if str(model.get("seed", "")).lower() == "random":
        model["seed"] = random.randint(0, 2**31 - 1)
    return config

