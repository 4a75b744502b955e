"""Global configuration tree.

Port of ``veles_tpu/config.py``: an auto-vivifying attribute tree
(attribute access creates sub-configs on the fly; ``update`` merges
dicts; values are plain leaves; ``protect`` freezes keys; config files
are executed Python that assigns into ``root``). The port keeps its own
tree, :data:`root`, with its own ``root.common.*`` defaults: the keys
its modules read. Later slices add theirs.
"""

from __future__ import annotations

import os
import pprint
from typing import Any, Dict


class ConfigError(Exception):
    pass


class Config:
    """Auto-vivifying configuration node.

    ``cfg.a.b.c = 1`` creates intermediate nodes; reading an undefined
    leaf returns a new empty Config node (truthiness False) so user code
    can probe optional settings. ``update({...})`` deep-merges a mapping.
    """

    __slots__ = ("__dict__", "_protected_")

    def __init__(self, path: str = "root", **kwargs: Any) -> None:
        object.__setattr__(self, "_protected_", set())
        self.__dict__["_path_"] = path
        for k, v in kwargs.items():
            setattr(self, k, v)

    # -- attribute protocol ------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_") and name.endswith("_"):
            raise AttributeError(name)
        child = Config("%s.%s" % (self.__dict__.get("_path_", "?"), name))
        self.__dict__[name] = child
        return child

    def __setattr__(self, name: str, value: Any) -> None:
        if name in self._protected_:
            raise ConfigError("Config key %s.%s is protected" %
                              (self.__dict__.get("_path_", "?"), name))
        if isinstance(value, dict) and not isinstance(value, Config):
            node = Config("%s.%s" % (self.__dict__.get("_path_", "?"), name))
            node.update(value)
            value = node
        self.__dict__[name] = value

    def __setitem__(self, name: str, value: Any) -> None:
        setattr(self, str(name), value)

    def __getitem__(self, name: str) -> Any:
        return getattr(self, str(name))

    def __contains__(self, name: str) -> bool:
        v = self.__dict__.get(name)
        return v is not None and not (isinstance(v, Config) and not v)

    def __bool__(self) -> bool:
        return bool(self._leaves_())

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._as_dict_() == other._as_dict_()
        return NotImplemented

    def __hash__(self):  # Configs are mutable containers
        return id(self)

    # -- operations --------------------------------------------------------
    def update(self, mapping: Dict[str, Any]) -> "Config":
        """Deep-merge a mapping (or another Config) into this node."""
        if isinstance(mapping, Config):
            mapping = mapping._as_dict_()
        for k, v in mapping.items():
            cur = self.__dict__.get(k)
            if isinstance(v, dict):
                if not isinstance(cur, Config):
                    cur = Config("%s.%s" % (self.__dict__.get("_path_", "?"), k))
                    self.__dict__[k] = cur
                cur.update(v)
            else:
                setattr(self, k, v)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        v = self.__dict__.get(name)
        if v is None or (isinstance(v, Config) and not v):
            return default
        return v

    def protect(self, *names: str) -> None:
        """Make keys read-only (reference: veles/config.py protect())."""
        self._protected_.update(names)

    def _leaves_(self) -> Dict[str, Any]:
        return {k: v for k, v in self.__dict__.items()
                if not (k.startswith("_") and k.endswith("_"))
                and not (isinstance(v, Config) and not v)}

    def _as_dict_(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for k, v in self._leaves_().items():
            out[k] = v._as_dict_() if isinstance(v, Config) else v
        return out

    def print_(self) -> str:
        return pprint.pformat(self._as_dict_())

    def __repr__(self) -> str:
        return "<Config %s: %s>" % (self.__dict__.get("_path_", "?"),
                                    pprint.pformat(self._as_dict_(), compact=True))


#: The global configuration tree of the port.
root = Config("root")

# Engine: backend is "cuda" | "cpu" | "auto" ("auto" = CUDA, raising
# without a GPU: the CPU runs only when asked for). Parameters and
# accumulation stay f32; activations run in the compute dtype.
root.common.engine.backend = "auto"
root.common.engine.precision_type = "float32"     # parameter / accum dtype
root.common.engine.compute_type = "bfloat16"      # tensor-core compute dtype

# Where SyntheticDigitsLoader looks for a real mnist.npz, and where a
# Snapshotter writes when given no directory
root.common.dirs.datasets = os.path.expanduser(
    os.environ.get("VELES_TPU_DATA", "~/.veles_tpu/datasets"))
root.common.dirs.snapshots = os.path.expanduser(
    os.environ.get("VELES_TPU_SNAPSHOTS", "~/.veles_tpu/snapshots"))

root.common.trace.run = False          # per-unit timing prints
root.common.random.seed = 42

# Non-finite training sentinel (FusedClassifierTrainer /
# TransformerTrainer): "warn" counts on the device and logs a few
# dispatches late; "skip" leaves params and optimizer state bitwise
# untouched on a non-finite step; "raise" syncs and raises.
root.common.train.nan_policy = "warn"

# Static graph verification policy (veles_tpu_torch.analysis.graph),
# run at the top of Workflow.initialize: "error" raises on provable
# graph defects, "warn" logs them, "off" skips the pass.
root.common.analysis.verify = "error"

# Raise RunAfterStopError when a stopped unit is re-triggered.
root.common.exceptions.run_after_stop = True

root.common.web.host = "localhost"
root.common.web.port = 8090
# When set (http://host:port), the Launcher POSTs periodic status
# documents there (reference: veles/launcher.py:852-885 -> web_status).
root.common.web.status_url = None
root.common.web.status_interval = 10.0
# When set, the Launcher owns a GraphicsServer rendering the
# workflow's plotter units into this directory (reference: the
# Launcher launched GraphicsServer — veles/launcher.py:431-548);
# broadcast = "host:port" also streams every spec to subscribers.
root.common.graphics.dir = None
root.common.graphics.spawn_process = True
root.common.graphics.broadcast = None
root.common.api.port = 8180
root.common.forge.dir = os.path.expanduser("~/.veles_tpu_torch/forge")

root.common.snapshot.compression = "gz"
root.common.snapshot.interval = 1


def get(cfg_value: Any, default: Any = None) -> Any:
    """Return a config leaf or ``default`` when unset (empty Config)."""
    if isinstance(cfg_value, Config):
        return default if not cfg_value else cfg_value._as_dict_()
    return cfg_value if cfg_value is not None else default


def apply_config_file(path: str) -> None:
    """Execute a Python config file with ``root`` in scope.

    Reference: config files are executed Python assigning into the
    global tree (veles/__main__.py:426-481).
    """
    with open(path, "r") as fin:
        src = fin.read()
    exec(compile(src, path, "exec"), {"root": root, "os": os})


def apply_overrides(overrides) -> None:
    """Apply ``a.b.c=value`` command-line override strings."""
    import ast
    for item in overrides:
        key, _, raw = item.partition("=")
        if not _:
            raise ConfigError("Override %r is not of form key=value" % item)
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = root
        parts = key.strip().split(".")
        if parts[0] == "root":
            parts = parts[1:]
        for p in parts[:-1]:
            node = getattr(node, p)
        setattr(node, parts[-1], value)
