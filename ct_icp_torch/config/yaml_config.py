"""The configuration files (``configs/*.yaml``): a reader for the YAML they
are written in, the option readers (counterpart of
``ct_icp_tpu/config/yaml_config.py``, :23-168: the reference's
``yaml_to_*_options``, config.cpp:26-321, and the runner's config) and the
synthetic scene and sequence loaders (:175-264).

The port does not depend on PyYAML. :func:`load_yaml` reads the subset of
YAML those files use and gives what ``yaml.safe_load`` gives for it:
  * block mappings (``key: value``, ``key:`` followed by a deeper block);
  * block sequences (``- value``, ``- key: value`` opening a mapping whose
    further keys sit under the first one), also at the parent key's indent;
  * flow sequences (``[1.0, [2, 3]]``), which may run over several lines;
  * plain scalars resolved as YAML 1.1 does: int (decimal), float (with a
    dot, or .inf / .nan), bool (true / false / yes / no / on / off in
    their three spellings), null (``~``, ``null``, empty), else a string;
    single- or double-quoted strings (without escapes), also as keys;
  * ``#`` comments, on their own line or after a value.
Anchors, tags, flow mappings, block scalars and multi-document files raise
ValueError.
"""

from __future__ import annotations

import dataclasses
import enum
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ct_icp_torch.config import options as O
from ct_icp_torch.datasets import synthetic as syn

_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}


def _scalar(text: str) -> Any:
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] and t[0] in "'\"":
        return t[1:-1]
    if t and t[0] in "&*!|>{":
        raise ValueError(f"yaml: unsupported construct {t!r}")
    if t in _NULL:
        return None
    if t in _TRUE:
        return True
    if t in _FALSE:
        return False
    if _INT.match(t):
        return int(t.replace("_", ""))
    if _FLOAT.match(t):
        return float(t.replace("_", ""))
    if _INF.match(t):
        return float("-inf") if t[0] == "-" else float("inf")
    if _NAN.match(t):
        return float("nan")
    return t


def _flow(text: str) -> Any:
    """A flow sequence (nested lists of scalars), or a scalar."""
    t = text.strip()
    if not t.startswith("["):
        return _scalar(t)
    pos = 0

    def parse():
        nonlocal pos
        assert t[pos] == "["
        pos += 1
        out: List[Any] = []
        item = ""
        while pos < len(t):
            ch = t[pos]
            if ch == "[":
                out.append(parse())
                item = None
                continue
            if ch in ",]":
                if item is not None and item.strip():
                    out.append(_scalar(item))
                item = ""
                pos += 1
                if ch == "]":
                    return out
                continue
            if item is None:
                if not ch.isspace():
                    raise ValueError(f"yaml: bad flow sequence {t!r}")
            else:
                item += ch
            pos += 1
        raise ValueError(f"yaml: unclosed flow sequence {t!r}")

    value = parse()
    if t[pos:].strip():
        raise ValueError(f"yaml: text after a flow sequence in {t!r}")
    return value


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def _lines(text: str) -> List[Tuple[int, str]]:
    """(indent, content) of each meaningful line, a flow sequence that runs
    over several lines joined into one."""
    out: List[Tuple[int, str]] = []
    pending = None
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if pending is not None:
            pending = (pending[0], pending[1] + " " + line.strip())
            if pending[1].count("[") <= pending[1].count("]"):
                out.append(pending)
                pending = None
            continue
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise ValueError("yaml: one document without markers only")
        if "\t" in line[:len(line) - len(line.lstrip())]:
            raise ValueError("yaml: tabs in indentation")
        item = (len(line) - len(line.lstrip(" ")), line.strip())
        if item[1].count("[") > item[1].count("]"):
            pending = item
        else:
            out.append(item)
    if pending is not None:
        raise ValueError("yaml: unclosed flow sequence at the end")
    return out


def _split_key(content: str):
    """``key: value`` -> (key, value text), else None. The key is plain or
    quoted (``"00": value``, as the runner's metrics.yaml writes it)."""
    m = re.match(r"^([^\s'\"\[\]{}#:][^:#]*?|\"[^\"]*\"|'[^']*')\s*:"
                 r"(?:\s+(.*)|)$", content)
    if m is None:
        return None
    return m.group(1), (m.group(2) or "")


def _parse_block(lines, i: int, indent: int):
    """The block starting at ``lines[i]`` (at ``indent``) -> (value, next
    line index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        return _parse_seq(lines, i, indent)
    return _parse_map(lines, i, indent)


def _value_after_key(lines, i: int, indent: int, rest: str):
    """The value of a key whose line is ``lines[i - 1]``: inline ``rest``,
    else the deeper block (or a sequence at the key's own indent)."""
    if rest.strip():
        return _flow(rest), i
    if i < len(lines):
        ind, content = lines[i]
        if ind > indent or (ind == indent and (content.startswith("- ")
                                               or content == "-")):
            return _parse_block(lines, i, ind)
    return None, i


def _parse_map(lines, i: int, indent: int):
    out = {}
    while i < len(lines):
        ind, content = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"yaml: unexpected indent at {content!r}")
        kv = _split_key(content)
        if kv is None:
            raise ValueError(f"yaml: expected 'key: value', got {content!r}")
        key, rest = kv
        out[_scalar(key)], i = _value_after_key(lines, i + 1, indent, rest)
    return out, i


def _parse_seq(lines, i: int, indent: int):
    out = []
    while i < len(lines):
        ind, content = lines[i]
        if ind < indent or not (content.startswith("- ") or content == "-"):
            if ind > indent:
                raise ValueError(f"yaml: unexpected indent at {content!r}")
            break
        if ind > indent:
            raise ValueError(f"yaml: unexpected indent at {content!r}")
        rest = content[1:].lstrip()
        if not rest:
            value, i = _value_after_key(lines, i + 1, indent, "")
        elif not rest.startswith("[") and _split_key(rest) is not None:
            # "- key: value" opens a mapping whose further keys sit under
            # its first key: parse the line as that key alone
            inner = indent + len(content) - len(rest)
            lines[i] = (inner, rest)
            value, i = _parse_map(lines, i, inner)
        else:
            value, i = _flow(rest), i + 1
        out.append(value)
    return out, i


def load_yaml(text: str) -> Any:
    """The document in ``text`` (the subset above), as ``yaml.safe_load``
    gives it."""
    lines = _lines(text)
    if not lines:
        return None
    if len(lines) == 1 and _split_key(lines[0][1]) is None and not (
            lines[0][1].startswith("- ") or lines[0][1] == "-"):
        return _flow(lines[0][1])
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"yaml: unexpected line {lines[i][1]!r}")
    return value


def read_yaml(path: str) -> Any:
    with open(path) as f:
        return load_yaml(f.read())


# ------------------------------------------------------------ option readers —

def _fill_dataclass(cls, node: Optional[Dict], base=None, skip=()):
    """Overlay YAML keys on a (frozen) dataclass instance, coercing enums."""
    obj = base if base is not None else cls()
    if not node:
        return obj
    updates = {}
    for f in dataclasses.fields(cls):
        if f.name in skip or f.name not in node:
            continue
        val = node[f.name]
        cur = getattr(obj, f.name)
        if isinstance(cur, enum.Enum):
            updates[f.name] = type(cur)[str(val)]
        elif isinstance(cur, bool):
            updates[f.name] = bool(val)
        elif isinstance(cur, int) and not isinstance(cur, bool):
            updates[f.name] = int(val)
        elif isinstance(cur, float):
            updates[f.name] = float(val)
        elif isinstance(cur, str):
            updates[f.name] = str(val)
        # nested dataclasses handled explicitly by the callers
    return dataclasses.replace(obj, **updates)


def yaml_to_ct_icp_options(node: Dict) -> O.CTICPOptions:
    """Reference yaml_to_ct_icp_options (config.cpp:26-122)."""
    return _fill_dataclass(O.CTICPOptions, node)


def yaml_to_map_options(node: Dict) -> O.MultiResolutionVoxelMapOptions:
    """Reference yaml_to_map_options (map.h:612, src/ct_icp/map.cpp)."""
    base = O.MultiResolutionVoxelMapOptions()
    if not node:
        return base
    resolutions = []
    if "resolutions" in node:
        for i, rnode in enumerate(node["resolutions"]):
            default = (base.resolutions[i] if i < len(base.resolutions)
                       else O.ResolutionParam())
            resolutions.append(_fill_dataclass(O.ResolutionParam, rnode,
                                               base=default))
    else:
        resolutions = list(base.resolutions)
    out = _fill_dataclass(O.MultiResolutionVoxelMapOptions, node)
    return dataclasses.replace(out, resolutions=tuple(resolutions))


def yaml_to_motion_model_options(node: Dict) -> O.MotionModelOptions:
    """Reference yaml_to_motion_model_options (config.cpp:304-318)."""
    return _fill_dataclass(O.MotionModelOptions, node)


def yaml_to_odometry_options(node: Dict) -> O.OdometryOptions:
    """Reference yaml_to_odometry_options (config.cpp:132-255)."""
    opts = _fill_dataclass(O.OdometryOptions, node)
    updates: Dict[str, Any] = {}
    if "map_options" in node:
        updates["map_options"] = yaml_to_map_options(node["map_options"])
    if "neighborhood_strategy" in node:
        snode = node["neighborhood_strategy"]
        stype = snode.get("type", "NEAREST_NEIGHBOR_STRATEGY")
        if stype == "DISTANCE_BASED_STRATEGY":
            updates["distance_strategy"] = _fill_dataclass(
                O.DistanceBasedStrategyOptions, snode)
        updates["neighborhood_strategy"] = _fill_dataclass(
            O.NearestNeighborStrategyOptions, snode)
    if "default_motion_model" in node:
        updates["default_motion_model"] = yaml_to_motion_model_options(
            node["default_motion_model"])
    if "ct_icp_options" in node:
        updates["ct_icp_options"] = yaml_to_ct_icp_options(node["ct_icp_options"])
    if "adaptive_options" in node:
        updates["adaptive_options"] = _fill_dataclass(
            O.AdaptiveGridSamplingOptions, node["adaptive_options"])
    if "backend" in node:
        updates["backend"] = _fill_dataclass(
            O.BackendOptions, node["backend"])
    return dataclasses.replace(opts, **updates)


def yaml_to_dataset_options(node: Dict):
    """Reference yaml_to_dataset_options (config.cpp:264-301)."""
    from ct_icp_torch.datasets.dataset import DatasetEnum, DatasetOptions
    opts = DatasetOptions()
    if "dataset" in node:
        opts.dataset = DatasetEnum[str(node["dataset"])]
    for key in ("root_path", "fail_if_incomplete", "min_dist_lidar_center",
                "max_dist_lidar_center", "nclt_num_aggregated_pc",
                "use_all_datasets"):
        if key in node:
            setattr(opts, key, node[key])
    if "sequence_options" in node:
        opts.sequence_options = list(node["sequence_options"])
    return opts


def yaml_to_dataset_options_vector(node_list: List[Dict]):
    return [yaml_to_dataset_options(n) for n in node_list]


@dataclasses.dataclass
class RunnerConfig:
    """Runner-level config (reference command/odometry_runner.h)."""

    odometry_options: O.OdometryOptions = dataclasses.field(
        default_factory=O.OdometryOptions)
    dataset_options: List = dataclasses.field(default_factory=list)
    output_dir: str = ".outputs"
    output_results: bool = True
    generate_directory_prefix: bool = True
    progress_bar: bool = True
    debug_information: bool = False
    exit_early: bool = True
    compute_metrics_period: int = 200
    max_frames: int = -1
    use_outdoor_evaluation: bool = True
    save_mid_frame_trajectory: bool = True
    #: write an interactive standalone viewer.html per sequence (viewer.py)
    html_viewer: bool = False


def load_runner_config(path: str) -> RunnerConfig:
    return runner_config_from_node(read_yaml(path))


def runner_config_from_node(root: Dict) -> RunnerConfig:
    cfg = RunnerConfig()
    for key in ("output_dir", "output_results", "generate_directory_prefix",
                "progress_bar", "debug_information", "exit_early",
                "compute_metrics_period", "max_frames",
                "use_outdoor_evaluation", "save_mid_frame_trajectory",
                "html_viewer"):
        if key in root:
            setattr(cfg, key, root[key])
    if "odometry_options" in root:
        cfg.odometry_options = yaml_to_odometry_options(root["odometry_options"])
    if "dataset_options" in root:
        cfg.dataset_options = yaml_to_dataset_options_vector(
            root["dataset_options"])
    return cfg


def read_odometry_options(path: str) -> O.OdometryOptions:
    return yaml_to_odometry_options(read_yaml(path))


# ----------------------------------------------------------- synthetic YAML —

def synthetic_scene_from_node(node) -> syn.Scene:
    """A scene from its list of primitive dicts (reference synthetic.h YAML
    (de)serialization)."""
    prims = []
    for p in node:
        ptype = str(p.get("type", "")).lower()
        if ptype == "triangle":
            prims.append(syn.Triangle(p["a"], p["b"], p["c"]))
        elif ptype == "line":
            prims.append(syn.Line(p["a"], p["b"]))
        elif ptype == "sphere":
            prims.append(syn.Sphere(p["center"], float(p["radius"])))
        elif ptype == "ball":
            prims.append(syn.Ball(p["center"], float(p["radius"])))
        elif ptype == "rectangle":
            prims.extend(syn.rectangle(p["corner"], p["edge_u"], p["edge_v"]))
        elif ptype in ("box_room", "room"):
            prims.extend(syn.box_room(float(p.get("half_extent", 10.0)),
                                      float(p.get("height", 4.0))))
        elif ptype == "indoor_rooms":
            prims.extend(syn.indoor_rooms(
                n_rooms=int(p.get("n_rooms", 4)),
                room=(float(p.get("room_w", 6.0)),
                      float(p.get("room_d", 5.0))),
                corridor_w=float(p.get("corridor_w", 2.0)),
                height=float(p.get("height", 2.6)),
                n_clutter=int(p.get("n_clutter", 10)),
                seed=int(p.get("seed", 0))))
        elif ptype == "city_blocks":
            prims.extend(syn.city_blocks(
                nx=int(p.get("nx", 5)), ny=int(p.get("ny", 3)),
                block=float(p.get("block", 40.0)),
                street=float(p.get("street", 14.0)),
                height=float(p.get("height", 8.0)),
                relief_every=float(p.get("relief_every", 8.0)),
                n_obstacles=int(p.get("n_obstacles", 60)),
                seed=int(p.get("seed", 0))))
        else:
            raise ValueError(f"Unknown primitive type {ptype}")
    return syn.Scene(prims)


def synthetic_sequence_from_yaml(path: str, seed=None
                                 ) -> syn.SyntheticSensorAcquisition:
    """The acquisition (scene, trajectory, sensor) of a synthetic scene
    file; ``acq.frame(i)`` renders frame i. ``seed`` overrides the file's
    scan-realization seed (the scene stays the same), as the multi-seed
    gates do. The reference wraps the same acquisition in a dataset
    sequence (its ``.acq``)."""
    root = read_yaml(path)
    scene = synthetic_scene_from_node(root.get("scene", []))
    tnode = root.get("trajectory", {"type": "circle"})
    ttype = str(tnode.get("type", "circle")).lower()
    if ttype == "circle":
        traj = syn.circular_trajectory(
            radius=float(tnode.get("radius", 8.0)),
            height=float(tnode.get("height", 1.5)),
            num_poses=int(tnode.get("num_poses", 200)),
            total_time=float(tnode.get("total_time", 10.0)),
            angle_span=float(tnode.get("angle_span", 2 * np.pi)))
    elif ttype == "drive":
        traj = syn.waypoint_drive_trajectory(
            tnode["waypoints"],
            speed_profile=tnode.get("speed_profile"),
            height=float(tnode.get("height", 1.7)),
            pose_rate=float(tnode.get("pose_rate", 20.0)),
            corner_radius=float(tnode.get("corner_radius", 4.0)),
            max_accel=float(tnode.get("max_accel", 2.5)),
            sway_deg=float(tnode.get("sway_deg", 0.0)),
            sway_period_s=float(tnode.get("sway_period_s", 1.2)),
            bob_amp=float(tnode.get("bob_amp", 0.0)),
            max_yaw_rate_dps=float(tnode.get("max_yaw_rate_dps", 0.0)))
    else:
        raise ValueError(f"Unknown trajectory type {ttype}")
    acq_node = root.get("acquisition", {})
    opts = syn.SyntheticAcquisitionOptions(
        num_points_per_frame=int(acq_node.get("num_points_per_frame", 20000)),
        frame_duration=float(acq_node.get("frame_duration", 0.1)),
        max_range=float(acq_node.get("max_range", 100.0)),
        min_range=float(acq_node.get("min_range", 0.5)),
        noise_sigma=float(acq_node.get("noise_sigma", 0.0)),
        windowed=bool(acq_node.get("windowed", False)))
    return syn.SyntheticSensorAcquisition(
        scene, traj, opts,
        seed=int(root.get("seed", 0)) if seed is None else int(seed))
