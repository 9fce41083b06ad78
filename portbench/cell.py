"""A cell of BENCHMARK.json as data: its configuration
(portbench/configs/<config>.json), its traffic (portbench/traffic/<traffic>.json)
and its limits (portbench/limits/<cell>.json), found by name; the inputs its
configuration names, made by the frozen makers of portbench/inputs/; and the
render options both sides build from the same data.

Imports neither torch's device code nor the program: the reference and
the program side each pass their own settings module to ``options``.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
# every cache of a run (kernel builds, written inputs): a fixed folder inside
# the checkout, so that only a checkout's first run builds
CACHE = os.path.join(HERE, ".cache")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict

    @property
    def resolution(self) -> tuple:
        w, h = self.config["resolution"]
        return int(w), int(h)

    @property
    def ranks(self) -> int:
        return int(self.traffic.get("ranks", 1))

    @property
    def strategy(self) -> str:
        return self.traffic["options"].get(
            "direct_light_sampling",
            self.config.get("options", {}).get("direct_light_sampling", "MIS"))

    @property
    def restir(self) -> bool:
        return self.strategy == "RESTIR_DI"


def load_cell(name: str, bench_path: str = BENCHMARK) -> Cell:
    """The cell ``name`` of the benchmark file, with its configuration,
    traffic and limits read from their files beside it (the configuration
    at its ``file``; traffic and limits under portbench/)."""
    root = os.path.dirname(os.path.abspath(bench_path))
    here = os.path.join(root, "portbench")
    bench = load_json(bench_path)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_path}; there are "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = load_json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    limits_path = os.path.join(here, "limits", name + ".json")
    limits = load_json(limits_path) if os.path.exists(limits_path) else {}
    return Cell(name=name, chips=int(w["chips"]), config=cfg, traffic=traffic,
                limits=limits)


def _value(default, v):
    """A JSON value as the field whose default is ``default`` takes it: an
    enum member by its name."""
    if isinstance(default, enum.Enum) and isinstance(v, str):
        return type(default)[v]
    return v


def options(cell: Cell, settings_module):
    """(RenderOptions, RenderSettings, WorldSettings) of ``settings_module``
    (the program's core/settings.py or the reference's copy): the
    configuration's fields, then the traffic's over them; an enum by its
    member's name; ambient_light_type by AmbientLightType's name."""
    sm = settings_module
    out = []
    for key, cls in (("options", sm.RenderOptions), ("settings", sm.RenderSettings),
                     ("world", sm.WorldSettings)):
        fields = {**cell.config.get(key, {}), **cell.traffic.get(key, {})}
        defaults = cls()
        kw = {}
        for k, v in fields.items():
            if k == "ambient_light_type":
                kw[k] = int(sm.AmbientLightType[v])
            else:
                kw[k] = _value(getattr(defaults, k), v)
        out.append(cls(**kw))
    return tuple(out)


def inputs(cell: Cell, cache: str = CACHE) -> dict:
    """The inputs the configuration names, made by portbench/inputs/ and
    handed alike to the program and the reference: {"glb": path} of the
    stress interior written as a binary glTF (cached under ``cache`` at a
    fixed path, written once per checkout), or {"arrays": (vertices,
    triangles, material ids, material rows, look-at camera kwargs),
    "envmap": texels} of the Cornell box."""
    sc = cell.config["scene"]
    w, h = cell.resolution
    if sc["maker"] == "stress_glb":
        path = os.path.join(cache, "inputs", cell.config["name"] + ".glb")
        if not os.path.exists(path):
            from .inputs.glb import write_glb
            from .inputs.stress import generate_stress_scene

            parsed = generate_stress_scene(
                seed=sc["seed"], tri_scale=sc["tri_scale"],
                num_emitters=sc["num_emitters"], texture_size=sc["texture_size"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            write_glb(tmp, parsed, alpha_materials=tuple(sc["cutouts"]))
            os.replace(tmp, path)
        return {"glb": path, "aspect": w / h}
    if sc["maker"] == "cornell_envmap":
        from .inputs.cornell import cornell_spheres_arrays
        from .inputs.envmap import make_test_envmap

        env = sc["envmap"]
        return {"arrays": cornell_spheres_arrays(w / h), "aspect": w / h,
                "envmap": make_test_envmap(env["height"], env["width"], env["kind"])}
    raise ValueError(f"unknown scene maker {sc['maker']!r}")
