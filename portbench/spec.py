"""``BENCHMARK.json`` and the files it names: loading, lookup by name, and
the check that every name resolves to its file.

Nothing here imports torch, so the check runs anywhere."""
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_spec(root: Path = ROOT) -> dict:
    with open(root / 'BENCHMARK.json') as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def workload(spec: dict, name: str) -> dict:
    for cell in spec['workloads']:
        if cell['name'] == name:
            return cell
    raise KeyError(f'no workload {name!r} in BENCHMARK.json')


def config_entry(spec: dict, name: str) -> dict:
    for cfg in spec['configs']:
        if cfg['name'] == name:
            return cfg
    raise KeyError(f'no configuration {name!r} in BENCHMARK.json')


def config_file(spec: dict, name: str, root: Path = ROOT) -> dict:
    return load_json(root / config_entry(spec, name)['file'])


def traffic_file(name: str, root: Path = ROOT) -> dict:
    return load_json(root / 'portbench' / 'traffic' / f'{name}.json')


def limits_file(cell: str, root: Path = ROOT) -> dict:
    return load_json(root / 'portbench' / 'limits' / f'{cell}.json')


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path: metric files carry dots in their names."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f'cannot load {path}')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def driver_module(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / 'portbench' / 'drivers' / f'{name}.py', f'portbench_driver_{name}')


def metric_module(name: str, root: Path = ROOT) -> ModuleType:
    return load_module(root / 'portbench' / 'metrics' / f'{name}.py',
                       'portbench_metric_' + name.replace('.', '_').replace('-', '_'))


def end_to_end_for(spec: dict, cell: str) -> List[dict]:
    """The end-to-end metrics a cell reports: those without ``workloads``,
    and those whose ``workloads`` name it."""
    return [m for m in spec['end_to_end'] if cell in m.get('workloads', [cell])]


def per_layer_for(spec: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell's traced run reports: those whose
    ``workloads`` name it, and those without the key whose ``moves`` the
    cell reports."""
    moved = {m['name'] for m in end_to_end_for(spec, cell)}
    return [m for m in spec['per_layer']
            if (cell in m['workloads'] if 'workloads' in m else m['moves'] in moved)]


def validate(spec: dict, root: Path = ROOT) -> List[str]:
    """That every name resolves: each configuration's file, each cell's
    configuration, traffic file, driver and limits file, each per-layer
    metric's reader and the end-to-end metric it moves, reported by the
    cells it names.  Returns the faults found (empty: none)."""
    errors: List[str] = []
    cfg_names = {cfg['name'] for cfg in spec['configs']}
    for cfg in spec['configs']:
        if not (root / cfg['file']).is_file():
            errors.append(f'{cfg["name"]}: no file {cfg["file"]}')
    cells = set()
    for cell in spec['workloads']:
        cells.add(cell['name'])
        if cell['config'] not in cfg_names:
            errors.append(f'{cell["name"]}: unknown configuration {cell["config"]}')
        traffic = root / 'portbench' / 'traffic' / f'{cell["traffic"]}.json'
        if not traffic.is_file():
            errors.append(f'{cell["name"]}: no traffic file {traffic.name}')
            continue
        driver = load_json(traffic).get('driver')
        if not (root / 'portbench' / 'drivers' / f'{driver}.py').is_file():
            errors.append(f'{cell["name"]}: no driver {driver!r}')
        if not (root / 'portbench' / 'limits' / f'{cell["name"]}.json').is_file():
            errors.append(f'{cell["name"]}: no limits file')
    e2e_names = {m['name'] for m in spec['end_to_end']}
    for m in spec['per_layer']:
        if m['moves'] not in e2e_names:
            errors.append(f'{m["name"]}: moves unknown metric {m["moves"]}')
        if not (root / 'portbench' / 'metrics' / f'{m["name"]}.py').is_file():
            errors.append(f'{m["name"]}: no reader file')
        for cell in m.get('workloads', []):
            if cell not in cells:
                errors.append(f'{m["name"]}: unknown workload {cell}')
            elif m['moves'] not in {e['name'] for e in end_to_end_for(spec, cell)}:
                errors.append(f'{m["name"]}: {cell} does not report {m["moves"]}')
    for cell in cells:
        if not per_layer_for(spec, cell):
            errors.append(f'{cell}: no per-layer metric')
    return errors
