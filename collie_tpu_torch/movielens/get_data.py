"""MovieLens 100K data access and metadata builders.

Port of ``collie_tpu/movielens/get_data.py`` (reference
``collie/movielens/get_data.py``): download and cache the ML-100K zip under
``$DATA_PATH/ml-100k`` (``:195-206``), read ``u.data`` / ``u.item`` /
``u.user`` with optional id decrement (``:12-185``), the posters CSV, local
or from GitHub (``:209-243``), one-hot item metadata (19 genres + 9 decades,
``:246-302``) and user metadata (age, gender, 21 occupations, ``:305-353``).
Nothing here uses torch: the frames equal ``collie_tpu``'s cell for cell.

Offline: when the dataset is absent and the download fails,
``read_movielens_df(synthetic_fallback=True)`` (or the environment variable
``COLLIE_TPU_SYNTHETIC_MOVIELENS=1``) generates an ML-100K-shaped synthetic
dataset with planted structure, from the same seeds as ``collie_tpu``.
``_write_movielens_100k`` writes frames in ML-100K's file format, so the
readers can run on them without the download.
"""
import os
import re
import zipfile
from pathlib import Path
from typing import Optional

import numpy as np
import pandas as pd

from collie_tpu_torch.config import DATA_PATH

GENRE_COLUMNS = ['unknown', 'Action', 'Adventure', 'Animation', 'Children', 'Comedy', 'Crime',
                 'Documentary', 'Drama', 'Fantasy', 'Film_Noir', 'Horror', 'Musical', 'Mystery',
                 'Romance', 'Sci_Fi', 'Thriller', 'War', 'Western']

OCCUPATIONS = ['administrator', 'artist', 'doctor', 'educator', 'engineer', 'entertainment',
               'executive', 'healthcare', 'homemaker', 'lawyer', 'librarian', 'marketing',
               'none', 'other', 'programmer', 'retired', 'salesman', 'scientist', 'student',
               'technician', 'writer']

#: ``u.item``'s column names, as the reader names them
ITEM_FILE_COLUMNS = ['item_id', 'movie_title', 'release_date', 'video_release_date',
                     'IMDb_URL'] + GENRE_COLUMNS
#: ``u.item``'s date format (``01-Jan-1995``)
RELEASE_DATE_FORMAT = '%d-%b-%Y'


def _synthetic_enabled(synthetic_fallback: Optional[bool]) -> bool:
    if synthetic_fallback is not None:
        return synthetic_fallback
    return os.environ.get('COLLIE_TPU_SYNTHETIC_MOVIELENS', '') not in ('', '0', 'false')


def read_movielens_df(decrement_ids: bool = True,
                      synthetic_fallback: Optional[bool] = None) -> pd.DataFrame:
    """``u.data`` as a DataFrame of user_id / item_id / rating / timestamp
    (reference ``get_data.py:12-59``), downloading the dataset if needed."""
    df_path = os.path.join(DATA_PATH, 'ml-100k', 'u.data')
    if not Path(df_path).exists():
        try:
            _download_movielens_100k()
        except Exception as download_error:  # zero-egress environments
            if _synthetic_enabled(synthetic_fallback):
                return _synthetic_movielens_df(decrement_ids=decrement_ids)
            raise RuntimeError(
                'MovieLens 100K is not cached under ``$DATA_PATH/ml-100k`` and the download '
                'failed (offline?). Pass ``synthetic_fallback=True`` or set '
                '``COLLIE_TPU_SYNTHETIC_MOVIELENS=1`` to use a synthetic stand-in.'
            ) from download_error

    df = pd.read_csv(df_path, sep='\t',
                     names=['user_id', 'item_id', 'rating', 'timestamp'])
    if decrement_ids:
        df.loc[:, 'user_id'] = df['user_id'] - 1
        df.loc[:, 'item_id'] = df['item_id'] - 1
    return df


def read_movielens_df_item(synthetic_fallback: Optional[bool] = None) -> pd.DataFrame:
    """``u.item`` with title, release date, and binary genre columns
    (reference ``get_data.py:62-143``)."""
    df_item_path = os.path.join(DATA_PATH, 'ml-100k', 'u.item')
    if not Path(df_item_path).exists():
        try:
            _download_movielens_100k()
        except Exception as download_error:
            if _synthetic_enabled(synthetic_fallback):
                return _synthetic_movielens_df_item()
            raise RuntimeError(
                'MovieLens 100K unavailable offline; see ``read_movielens_df`` docstring.'
            ) from download_error

    df_item = pd.read_csv(df_item_path, sep='|', encoding='latin-1', names=ITEM_FILE_COLUMNS)
    df_item['release_date'] = pd.to_datetime(df_item['release_date'])
    return df_item.drop(columns=['video_release_date'])


def read_movielens_df_user(synthetic_fallback: Optional[bool] = None) -> pd.DataFrame:
    """``u.user``: user_id, age, gender, occupation, zip
    (reference ``get_data.py:146-185``)."""
    df_user_path = os.path.join(DATA_PATH, 'ml-100k', 'u.user')
    if not Path(df_user_path).exists():
        try:
            _download_movielens_100k()
        except Exception as download_error:
            if _synthetic_enabled(synthetic_fallback):
                return _synthetic_movielens_df_user()
            raise RuntimeError(
                'MovieLens 100K unavailable offline; see ``read_movielens_df`` docstring.'
            ) from download_error

    return pd.read_csv(df_user_path, sep='|', encoding='latin-1',
                       names=['user_id', 'age', 'gender', 'occupation', 'zip'])


def _download_movielens_100k() -> None:
    """Download and extract the ML-100K zip under ``$DATA_PATH``
    (reference ``get_data.py:195-206``)."""
    import requests

    DATA_PATH.mkdir(parents=True, exist_ok=True)
    url = 'http://files.grouplens.org/datasets/movielens/ml-100k.zip'
    print('Downloading MovieLens 100K data...')
    req = requests.get(url, stream=True, timeout=30)
    req.raise_for_status()
    zip_path = os.path.join(DATA_PATH, 'ml-100k.zip')
    with open(zip_path, 'wb') as f:
        f.write(req.content)
    with zipfile.ZipFile(zip_path, 'r') as z:
        z.extractall(DATA_PATH)


def _write_movielens_100k(data_path, df: pd.DataFrame, df_item: pd.DataFrame,
                          df_user: pd.DataFrame) -> Path:
    """Write ``u.data`` (tab-separated), ``u.item`` and ``u.user``
    (``|``-separated, latin-1) under ``data_path/ml-100k`` in ML-100K's
    format, from frames shaped as the readers return them with 1-based ids
    (``read_movielens_df(decrement_ids=False)``): the inverse of the three
    readers.  Returns the directory."""
    directory = Path(data_path) / 'ml-100k'
    directory.mkdir(parents=True, exist_ok=True)
    df[['user_id', 'item_id', 'rating', 'timestamp']].to_csv(
        directory / 'u.data', sep='\t', header=False, index=False)
    items = df_item.copy()
    items['release_date'] = items['release_date'].dt.strftime(RELEASE_DATE_FORMAT)
    items['video_release_date'] = ''
    items[ITEM_FILE_COLUMNS].to_csv(directory / 'u.item', sep='|', header=False,
                                    index=False, encoding='latin-1')
    df_user[['user_id', 'age', 'gender', 'occupation', 'zip']].to_csv(
        directory / 'u.user', sep='|', header=False, index=False, encoding='latin-1')
    return directory


def read_movielens_posters_df() -> pd.DataFrame:
    """item_id -> poster URL, local CSV or origin GitHub
    (reference ``get_data.py:209-243``)."""
    local_path = Path(__file__).parent.parent.parent / 'data' / 'movielens_posters.csv'
    url = 'https://raw.githubusercontent.com/ShopRunner/collie/main/data/movielens_posters.csv'
    if local_path.exists():
        return pd.read_csv(local_path)
    return pd.read_csv(url)


def get_movielens_metadata(df_item: Optional[pd.DataFrame] = None) -> pd.DataFrame:
    """One-hot item metadata: 19 genres + 9 decades, genre_unknown moved to
    the end of the genre block (reference ``get_data.py:246-302``)."""
    if df_item is None:
        df_item = read_movielens_df_item()

    df_item_date = df_item.iloc[:, [2]].copy()
    df_item_date.loc[:, 'year'] = df_item_date['release_date'].dt.year.fillna(1900)
    df_item_date.loc[:, 'decade'] = ((df_item_date['year'] - 1900) / 10).astype('int64') * 10
    df_decades = pd.get_dummies(df_item_date.decade, prefix='decade').astype('int64')
    df_decades.columns = ['decade_unknown'] + df_decades.columns[1:].tolist()

    df_item_genre = df_item.iloc[:, list(range(4, 23))].copy()
    df_item_genre.columns = 'genre_' + df_item_genre.columns.str.lower()

    metadata_df = pd.merge(df_item_genre, df_decades, left_index=True, right_index=True)

    cols = metadata_df.columns.values.tolist()
    last_genre_element = list(filter(re.compile('genre*').match, cols))[-1]
    last_genre_index = cols.index(last_genre_element)
    cols.insert(last_genre_index + 1, 'genre_unknown')
    cols.remove('genre_unknown')
    return metadata_df[cols]


def get_user_metadata(df_user: Optional[pd.DataFrame] = None) -> pd.DataFrame:
    """User metadata: age, binary gender, one-hot occupations
    (reference ``get_data.py:305-353``)."""
    if df_user is None:
        df_user = read_movielens_df_user()

    df_occupation = pd.get_dummies(df_user[['occupation']].occupation,
                                   prefix='occupation').astype('int64')
    df_occupation = df_occupation.sort_index(axis=1)

    df_user = df_user.copy()
    df_user['gender'] = df_user.gender.replace({'F': 1, 'M': 0}).astype('int64')
    return df_user[['age', 'gender']].merge(df_occupation, left_index=True, right_index=True)


# ----------------------------------------------------- synthetic stand-ins

def _synthetic_movielens_df(decrement_ids: bool) -> pd.DataFrame:
    from collie_tpu_torch.data.synthetic import generate_interactions_df

    df = generate_interactions_df(num_users=943, num_items=1682,
                                  num_interactions=100_000, seed=100_000)
    if not decrement_ids:
        df = df.copy()
        df['user_id'] += 1
        df['item_id'] += 1
    return df


def _synthetic_movielens_df_item(num_items: int = 1682) -> pd.DataFrame:
    rng = np.random.default_rng(1682)
    genres = np.zeros((num_items, len(GENRE_COLUMNS)), dtype=np.int64)
    primary = rng.integers(1, len(GENRE_COLUMNS), num_items)
    genres[np.arange(num_items), primary] = 1
    extra = rng.integers(1, len(GENRE_COLUMNS), num_items)
    genres[np.arange(num_items), extra] = 1
    years = rng.integers(1922, 1999, num_items)
    df = pd.DataFrame({
        'item_id': np.arange(1, num_items + 1),
        'movie_title': [f'Synthetic Movie {i} ({y})' for i, y in enumerate(years, 1)],
        'release_date': pd.to_datetime([f'{y}-01-01' for y in years]),
        'IMDb_URL': [f'http://example.com/movie/{i}' for i in range(1, num_items + 1)],
    })
    for gi, name in enumerate(GENRE_COLUMNS):
        df[name] = genres[:, gi]
    return df


def _synthetic_movielens_df_user(num_users: int = 943) -> pd.DataFrame:
    rng = np.random.default_rng(943)
    return pd.DataFrame({
        'user_id': np.arange(1, num_users + 1),
        'age': rng.integers(18, 70, num_users),
        'gender': rng.choice(['M', 'F'], num_users),
        'occupation': rng.choice(OCCUPATIONS, num_users),
        'zip': rng.integers(10_000, 99_999, num_users).astype(str),
    })
