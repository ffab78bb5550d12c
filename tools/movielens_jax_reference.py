"""collie_tpu's ``run_movielens_example`` on the files ``chip_smoke.py``
phase 12 trains the port on, on the CPU.

The files are ML-100K's format (``u.data``, ``u.item``, ``u.user``) written
from collie_tpu's synthetic stand-ins, which equal the port's cell for cell
(``tests/test_torch_movielens.py`` holds both that and that ``write_files``
writes the bytes of the port's ``_write_movielens_100k``).  The download is
replaced by one that raises, so the readers read the files.  The example
seeds its split and model from the clock, in both packages, so this runs
it ``--runs`` times and prints each run's AUC, MRR and MAP@10, then one
JSON object of them as its last line.

    JAX_PLATFORMS=cpu python3 tools/movielens_jax_reference.py [--runs 3]
"""
import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

ITEM_FILE_COLUMNS = ['item_id', 'movie_title', 'release_date', 'video_release_date',
                     'IMDb_URL']
RELEASE_DATE_FORMAT = '%d-%b-%Y'


def write_files(data_path) -> Path:
    """collie_tpu's stand-ins in ML-100K's format under
    ``data_path/ml-100k``."""
    from collie_tpu.movielens import get_data

    df = get_data._synthetic_movielens_df(decrement_ids=False)
    items = get_data._synthetic_movielens_df_item()
    users = get_data._synthetic_movielens_df_user()
    directory = Path(data_path) / 'ml-100k'
    directory.mkdir(parents=True, exist_ok=True)
    df[['user_id', 'item_id', 'rating', 'timestamp']].to_csv(
        directory / 'u.data', sep='\t', header=False, index=False)
    items['release_date'] = items['release_date'].dt.strftime(RELEASE_DATE_FORMAT)
    items['video_release_date'] = ''
    items[ITEM_FILE_COLUMNS + get_data.GENRE_COLUMNS].to_csv(
        directory / 'u.item', sep='|', header=False, index=False, encoding='latin-1')
    users[['user_id', 'age', 'gender', 'occupation', 'zip']].to_csv(
        directory / 'u.user', sep='|', header=False, index=False, encoding='latin-1')
    return directory


def _offline():
    raise OSError('movielens_jax_reference: no download')


def run_once(data_path) -> dict:
    """One ``run_movielens_example()`` at its defaults; its printed metrics."""
    from collie_tpu.movielens import get_data, run

    get_data.DATA_PATH = run.DATA_PATH = Path(data_path)
    get_data._download_movielens_100k = _offline
    out = io.StringIO()
    start = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run.run_movielens_example()
    metrics = {}
    for line in out.getvalue().splitlines():
        for name, key in (('AUC:', 'auc'), ('MRR:', 'mrr'), ('MAP@10:', 'mapk')):
            if line.startswith(name):
                metrics[key] = float(line.split()[-1])
    metrics['seconds'] = time.perf_counter() - start
    return metrics


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--runs', type=int, default=3)
    args = parser.parse_args(argv)
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    runs = []
    with tempfile.TemporaryDirectory() as directory:
        write_files(directory)
        for _ in range(args.runs):
            runs.append(run_once(directory))
            print(runs[-1], flush=True)
    print(json.dumps({'collie_tpu_run_movielens_example_cpu': runs}))


if __name__ == '__main__':
    main()
