"""Copy of `jaeger_tpu/utils/registry.py`.

Model discovery and registry.

Parity targets: reference ``utils/misc.py:309-400`` (``AvailableModels``
scan + ``add_data_to_json`` registry append) and the ``register-models`` /
``download`` CLI (``cli.py:668-765``, ``commands/downloads.py``). A model
bundle here is a directory containing ``params.msgpack`` +
``project.yaml`` (+ ``classes.yaml``); the registry is a JSON file with a
``model_paths`` list.

Both packages read the same registry file (``$JAEGER_TPU_HOME/config.json``,
else ``~/.jaeger_tpu/config.json``) and the same bundle format, so a model
registered by either package resolves in both.
"""

from __future__ import annotations

import json
import os
from pathlib import Path


def default_registry_path() -> Path:
    base = os.environ.get(
        "JAEGER_TPU_HOME", str(Path.home() / ".jaeger_tpu")
    )
    return Path(base) / "config.json"


def load_registry(path: str | Path | None = None) -> dict:
    path = Path(path) if path else default_registry_path()
    if path.exists():
        return json.loads(path.read_text())
    return {"model_paths": []}


def add_to_registry(model_path: str, registry_path: str | Path | None = None):
    """Append a model path to the registry (atomic write)."""
    reg_path = Path(registry_path) if registry_path else default_registry_path()
    data = load_registry(reg_path)
    data.setdefault("model_paths", [])
    resolved = str(Path(model_path).resolve())
    if resolved not in data["model_paths"]:
        data["model_paths"].append(resolved)
    reg_path.parent.mkdir(parents=True, exist_ok=True)
    tmp = reg_path.with_name(reg_path.name + ".tmp")
    tmp.write_text(json.dumps(data, indent=2))
    os.replace(tmp, reg_path)
    return data


class AvailableModels:
    """Scan paths for jaeger-tpu model bundles."""

    def __init__(self, paths=None, registry_path=None):
        if paths is None:
            paths = load_registry(registry_path).get("model_paths", [])
        if isinstance(paths, (str, Path)):
            paths = [paths]
        self.paths = [Path(p) for p in paths]
        self.info = self._scan()

    def _scan(self) -> dict[str, dict]:
        models: dict[str, dict] = {}
        for path in self.paths:
            if not path.exists():
                continue
            candidates = [path] if (path / "params.msgpack").exists() else []
            candidates += [
                p.parent for p in path.rglob("params.msgpack")
                if p.parent not in candidates
            ]
            for bundle in candidates:
                if not (bundle / "project.yaml").exists():
                    continue
                try:
                    import yaml

                    cfg = yaml.safe_load(
                        (bundle / "project.yaml").read_text()
                    )
                    name = cfg.get("model", {}).get("name", bundle.name)
                except Exception:
                    name = bundle.name
                models[name] = {
                    "path": str(bundle),
                    "params": str(bundle / "params.msgpack"),
                    "project": str(bundle / "project.yaml"),
                    "classes": str(bundle / "classes.yaml"),
                }
        return models

    def resolve(self, name_or_path: str) -> str:
        """Resolve a model by registry name or filesystem path."""
        if name_or_path in self.info:
            return self.info[name_or_path]["path"]
        p = Path(name_or_path)
        if (p / "params.msgpack").exists():
            return str(p)
        raise FileNotFoundError(
            f"model {name_or_path!r} not found; known: {sorted(self.info)}"
        )


def download_models(url: str, dest_dir: str | Path,
                    registry_path=None) -> list[str]:
    """Download and register a model archive from a catalog URL.

    Parity role: reference ``commands/downloads.py`` (CKAN catalog +
    tar extraction). Network access may be unavailable in sealed
    environments; errors are surfaced to the caller.
    """
    import tarfile
    import urllib.request

    dest_dir = Path(dest_dir)
    dest_dir.mkdir(parents=True, exist_ok=True)
    archive = dest_dir / Path(url).name
    urllib.request.urlretrieve(url, archive)  # noqa: S310
    registered = []
    if archive.suffixes[-2:] in ([".tar", ".gz"], [".tar", ".xz"]) or \
            archive.suffix == ".tar":
        with tarfile.open(archive) as tf:
            tf.extractall(dest_dir, filter="data")
        for bundle in dest_dir.rglob("params.msgpack"):
            add_to_registry(bundle.parent, registry_path)
            registered.append(str(bundle.parent))
    return registered


#: CKAN catalog the reference publishes models through
#: (``commands/downloads.py:7-8``)
CKAN_API_URL = (
    "https://ckan.fdm.uni-greifswald.de/api/3/action/package_search"
)
CKAN_QUERY = "jaeger"


def list_model_catalog(api_url: str = CKAN_API_URL,
                       query: str = CKAN_QUERY,
                       timeout: float = 15.0) -> dict[str, str]:
    """Query the CKAN catalog for downloadable model archives.

    Parity: reference ``commands/downloads.py:12-49``
    (``list_ckan_model_download_links``) — returns {model_name: url}.
    Raises ``ConnectionError`` with a readable message when the network
    is unreachable (air-gapped clusters).
    """
    import json
    import urllib.error
    import urllib.parse
    import urllib.request

    full = f"{api_url}?{urllib.parse.urlencode({'q': query})}"
    try:
        with urllib.request.urlopen(full, timeout=timeout) as resp:  # noqa: S310
            result = json.load(resp)
    except (urllib.error.URLError, OSError, TimeoutError) as e:
        raise ConnectionError(
            f"model catalog unreachable ({e}); on air-gapped systems "
            f"download archives elsewhere and pass their path/URL to "
            f"`jaeger-tpu download`"
        ) from e
    if not result.get("success", False):
        raise ValueError("catalog API returned an unsuccessful response")
    links: dict[str, str] = {}
    for dataset in result.get("result", {}).get("results", []):
        for res in dataset.get("resources", []):
            name = res.get("name") or res.get("id", "model")
            url = res.get("url")
            if url:
                links[str(name)] = str(url)
    if not links:
        raise ValueError(f"no models found for query {query!r}")
    return links
