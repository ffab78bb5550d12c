"""Host-side helpers used by the data layer and the models.

A numpy / pandas copy of ``collie_tpu/utils.py``: ratings-matrix
construction, DataFrame -> ``Interactions`` conversion, implicit conversion,
user filtering, truncated-normal init, ctor-argument capture, HTML
rendering, a wall-clock timer, docstring merging and ``pandas_df_to_hdf5``,
the writer of the out-of-core tier's stores (``h5py``, imported where it
writes).  The accelerator never sees any of this.
"""
import datetime
import inspect
import time
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import pandas as pd
from scipy.sparse import coo_matrix


def get_random_seed() -> int:
    """Time-derived random seed (reference: ``utils.py:24-26``)."""
    return int(datetime.datetime.now().timestamp())


def _infer_num_if_needed(num: Union[int, str], array: Iterable[int]) -> int:
    """Resolve ``'infer'`` to ``max(array) + 1`` (reference: ``utils.py:89-94``)."""
    if isinstance(num, str):
        if num != 'infer':
            raise ValueError(f"Unrecognized num value: {num!r} (expected 'infer' or an int)")
        return int(np.asarray(array).max()) + 1
    return int(num)


def _create_sparse_ratings_matrix_helper(users: Iterable[int],
                                         items: Iterable[int],
                                         ratings: Optional[Iterable[float]] = None,
                                         num_users: Union[int, str] = 'infer',
                                         num_items: Union[int, str] = 'infer') -> coo_matrix:
    """Build a sparse COO users x items ratings matrix (reference: ``utils.py:60-86``)."""
    users = np.asarray(users)
    items = np.asarray(items)
    num_users = _infer_num_if_needed(num_users, users)
    num_items = _infer_num_if_needed(num_items, items)
    if ratings is None:
        ratings = np.ones_like(users, dtype=np.float64)
    else:
        ratings = np.asarray(ratings)
    return coo_matrix((ratings, (users, items)), shape=(num_users, num_items))


def create_ratings_matrix(df: pd.DataFrame,
                          user_col: str = 'user_id',
                          item_col: str = 'item_id',
                          ratings_col: str = 'rating',
                          sparse: bool = False) -> Union[np.ndarray, coo_matrix]:
    """DataFrame -> dense pivot or sparse COO ratings matrix (reference: ``utils.py:29-86``).

    IDs must start at 0; with ``sparse=False`` a dense ``num_users x num_items``
    array is returned, otherwise a ``scipy.sparse.coo_matrix``.
    """
    if df[user_col].min() != 0 or df[item_col].min() != 0:
        raise ValueError('User and item IDs must start at 0 to create the ratings matrix.')

    if sparse:
        return _create_sparse_ratings_matrix_helper(users=df[user_col].values,
                                                    items=df[item_col].values,
                                                    ratings=df[ratings_col].values)

    num_users = df[user_col].max() + 1
    num_items = df[item_col].max() + 1
    mat = np.zeros((num_users, num_items), dtype=np.float64)
    mat[df[user_col].values, df[item_col].values] = df[ratings_col].values
    return mat


def df_to_interactions(df: pd.DataFrame,
                       user_col: str = 'user_id',
                       item_col: str = 'item_id',
                       ratings_col: Optional[str] = 'rating',
                       **kwargs) -> 'Interactions':
    """DataFrame -> ``Interactions`` (reference: ``utils.py:97-125``)."""
    from collie_tpu_torch.data import Interactions

    ratings = df[ratings_col].values if ratings_col is not None else None
    return Interactions(users=df[user_col].values,
                        items=df[item_col].values,
                        ratings=ratings,
                        **kwargs)




def convert_to_implicit(df: pd.DataFrame,
                        min_rating_to_keep: float = 4,
                        user_col: str = 'user_id',
                        item_col: str = 'item_id',
                        ratings_col: str = 'rating') -> pd.DataFrame:
    """Explicit -> implicit: keep-max-rating dedup, drop sub-threshold ratings,
    set rating to 1 (reference: ``utils.py:128-165``).

    Duplicate (user, item) pairs keep the *highest* rating: the reference sorts
    by rating before the keep-last dedup (``utils.py:157-161``), so a pair that
    was ever rated above the threshold survives the conversion.
    """
    df = (df.sort_values(by=ratings_col, kind='stable')
            .drop_duplicates(subset=[user_col, item_col], keep='last').copy())
    df = df[df[ratings_col] >= min_rating_to_keep]
    df.loc[:, ratings_col] = 1
    return df.reset_index(drop=True)


def remove_users_with_fewer_than_n_interactions(df: pd.DataFrame,
                                                min_num_of_interactions: int = 3,
                                                user_col: str = 'user_id') -> pd.DataFrame:
    """Filter out low-activity users (reference: ``utils.py:168-193``)."""
    counts = df[user_col].value_counts()
    keep = counts[counts >= min_num_of_interactions].index
    return df[df[user_col].isin(keep)].reset_index(drop=True)


def trunc_normal(shape: Tuple[int, ...],
                 mean: float = 0.0,
                 std: float = 1.0,
                 seed: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Approximate truncated normal used for embedding init (reference: ``utils.py:196-206``).

    The reference uses the fastai trick ``normal().fmod_(2) * std + mean``; we
    reproduce the same distribution with numpy on host so parameter init does
    not depend on torch.
    """
    if rng is None:
        rng = np.random.default_rng(seed)
    return (np.fmod(rng.standard_normal(shape), 2) * std + mean).astype(np.float32)



def get_init_arguments(exclude: Optional[Iterable[str]] = (),
                       verbose: bool = False) -> Dict[str, Any]:
    """Capture the calling ``__init__``'s arguments as a flat kwargs dict.

    Frame-inspection equivalent of the reference's
    ``get_init_arguments`` (``utils.py:209-246``), used by every model to
    freeze its hyperparameters for save / load.

    ``exclude``: argument names to drop from the captured dict; names not
    present are ignored (printed when ``verbose``), matching the reference.
    """
    frame = inspect.currentframe().f_back
    args, varargs, varkw, values = inspect.getargvalues(frame)
    captured = {name: values[name] for name in args if name != 'self'}
    if varkw is not None:
        captured.update(values[varkw] or {})
    for exclude_arg in (exclude or ()):
        if exclude_arg in captured:
            del captured[exclude_arg]
        elif verbose:
            print(f'Key {exclude_arg} not found in ``init_args`` '
                  'and will be ignored.')
    return captured


def pandas_df_to_hdf5(df: pd.DataFrame,
                      out_path: Union[str, Path],
                      key: str = 'interactions') -> None:
    """Append a DataFrame to an HDF5 store (``collie_tpu/utils.py:161``;
    reference ``utils.py:249-258``): one resizable 1-d dataset per column
    under ``/<key>``, the layout ``HDF5Interactions`` reads.  h5py lists
    datasets name-sorted, so the group's ``column_order`` attribute keeps
    the DataFrame's order; an append that brings new columns extends it and
    never rewrites it."""
    import h5py

    with h5py.File(str(out_path), 'a') as f:
        grp = f.require_group(key)
        known = list(grp.attrs.get('column_order', ()))
        new = [str(c) for c in df.columns if str(c) not in known]
        if new or 'column_order' not in grp.attrs:
            grp.attrs['column_order'] = known + new
        for col in df.columns:
            data = df[col].to_numpy()
            if col in grp:
                ds = grp[col]
                old = ds.shape[0]
                ds.resize((old + len(data),))
                ds[old:] = data
            else:
                grp.create_dataset(col, data=data, maxshape=(None,), chunks=True)


def df_to_html(df: pd.DataFrame,
               image_cols: Iterable[str] = (),
               hyperlink_cols: Iterable[str] = (),
               html_tags: Optional[Dict[str, Union[str, Iterable[str]]]] = None,
               transpose: bool = False,
               image_width: Optional[int] = None,
               max_num_rows: int = 200,
               **kwargs) -> str:
    """Render a DataFrame to HTML with images / links / tags
    (reference: ``utils.py:261-408``).

    Reference semantics preserved exactly: image columns ignore all other
    transformations (hyperlink / html-tag transforms skip them), hyperlink
    anchors open in a new tab, and naming a column absent from ``df``
    raises ``ValueError``.
    """
    def _wrap_cols(cols) -> list:
        try:
            iter(cols)
        except TypeError:
            cols = [cols]
        if isinstance(cols, str):
            cols = [cols]
        return list(cols)

    if html_tags is None:
        html_tags = {}
    if max_num_rows is None or len(df) <= max_num_rows:
        df = df.copy()
    else:
        df = df.head(max_num_rows).copy()

    image_cols = _wrap_cols(image_cols)
    for col in image_cols:
        if col not in df.columns:
            raise ValueError(f'{col} not a column in df!')
        if not image_width:
            df[col] = df[col].map(lambda x: f'<img src="{x}">')
        else:
            df[col] = df[col].map(lambda x: f'<img src="{x}" width={image_width}>')

    for col in _wrap_cols(hyperlink_cols):
        if col not in df.columns:
            raise ValueError(f'{col} not a column in df!')
        if col in image_cols:
            continue
        df[col] = df[col].map(lambda x: f'<a target="_blank" href="{x}">{x}</a>')

    for col, tags in html_tags.items():
        if col not in df.columns:
            raise ValueError(f'{col} not a column in df!')
        if col in image_cols:
            continue
        if isinstance(tags, str):
            tags = [tags]
        opening = ''.join(f'<{t}>' for t in tags)
        closing = ''.join(f'</{t}>' for t in reversed(tags))
        df[col] = df[col].map(lambda x: f'{opening}{x}{closing}')

    max_colwidth = pd.get_option('display.max_colwidth')
    pd.set_option('display.max_colwidth', None)
    try:
        if transpose:
            df = df.T
        df_html = df.to_html(escape=False, **kwargs)
    finally:
        pd.set_option('display.max_colwidth', max_colwidth)
    return df_html


class Timer:
    """Wall-clock section timer (reference: ``utils.py:411-431``)."""

    def __init__(self):
        self.start_time = time.time()
        self.time = self.start_time

    def timecheck(self, message: str = 'Finished') -> float:
        now = time.time()
        delta_mins = (now - self.time) / 60
        self.time = now
        print(f'{message} ({delta_mins:.2f} min)')
        return round(delta_mins, 2)

    def time_since_start(self, message: str = 'Total time') -> float:
        delta_mins = (time.time() - self.start_time) / 60
        print(f'{message}: {delta_mins:.2f} min')
        return round(delta_mins, 2)



def merge_docstrings(base_class: type, subclass_doc: Optional[str], init: Any) -> Optional[str]:
    """Numpydoc-style docstring inheritance for model classes
    (reference: ``utils.py:434-592``).

    Parameters documented on the base class ``__init__`` but not on the
    subclass are merged into the subclass docstring, restricted to parameters
    the subclass ``__init__`` actually accepts.
    """
    if subclass_doc is None or base_class.__init__.__doc__ is None:
        return subclass_doc

    try:
        sig = inspect.signature(init)
    except (TypeError, ValueError):
        return subclass_doc
    # a subclass accepting **kwargs forwards every base parameter, so all of
    # the base's documented params merge (reference behavior: kwargs children
    # inherit the full parameter table, ``tests/test_docstring.py:356-443``)
    has_var_kw = any(p.kind is inspect.Parameter.VAR_KEYWORD
                     for p in sig.parameters.values())
    sig_params = set(sig.parameters) - {'self', 'kwargs', 'args'}

    base_params = _parse_numpydoc_parameters(base_class.__init__.__doc__)
    sub_params = _parse_numpydoc_parameters(subclass_doc)
    missing = {
        name: text for name, text in base_params.items()
        if name not in sub_params and not name.startswith('*')
        and (name in sig_params or has_var_kw)
    }
    if not missing:
        return subclass_doc
    return _insert_into_parameters_section(subclass_doc,
                                           list(missing.values()))


def _insert_into_parameters_section(doc: str, blocks: List[str]) -> str:
    """Insert parameter text blocks at the END of ``doc``'s numpydoc
    Parameters section — before any ``*args``/``**kwargs`` entries (those
    stay last, reference convention) and before any subsequent section
    (``Returns``/``References``/...).  Creates the section when absent.
    Blocks are re-indented to the section's parameter indentation."""
    lines = doc.split('\n')
    n = len(lines)
    start = None
    for idx in range(n - 1):
        nxt = lines[idx + 1].strip()
        if lines[idx].strip() == 'Parameters' and nxt and set(nxt) == {'-'}:
            start = idx + 2
            break

    def _reindent(block: str, target: int) -> str:
        first = block.split('\n')[0]
        have = len(first) - len(first.lstrip())
        delta = target - have
        if delta == 0:
            return block
        out = []
        for ln in block.split('\n'):
            if not ln.strip():
                out.append(ln)
            elif delta > 0:
                out.append(' ' * delta + ln)
            else:
                cur = len(ln) - len(ln.lstrip())
                out.append(ln[min(-delta, cur):])
        return '\n'.join(out)

    if start is None:
        addition = '\n'.join(_reindent(b, 4) for b in blocks)
        header = '\n    Parameters\n    ----------\n'
        return doc.rstrip() + header + addition + '\n'

    param_indent = None
    insert_at = start
    star_at = None
    idx = start
    while idx < n:
        stripped = lines[idx].strip()
        if not stripped:
            idx += 1
            continue
        nxt = lines[idx + 1].strip() if idx + 1 < n else ''
        if nxt and set(nxt) == {'-'}:
            break                        # next section header reached
        indent = len(lines[idx]) - len(lines[idx].lstrip())
        if param_indent is None:
            param_indent = indent
        if indent < param_indent:
            break                        # dedent: section body over
        if indent == param_indent and stripped.startswith('*') \
                and star_at is None:
            star_at = idx
        insert_at = idx + 1
        idx += 1

    pos = star_at if star_at is not None else insert_at
    addition = [_reindent(b, param_indent if param_indent is not None else 4)
                for b in blocks]
    new_lines = lines[:pos] + '\n'.join(addition).split('\n') + lines[pos:]
    return '\n'.join(new_lines)


def _parse_numpydoc_parameters(doc: str) -> Dict[str, str]:
    """Extract ``name -> full text block`` entries from a numpydoc Parameters
    section, using indentation relative to the section body (docstrings of
    classes and methods indent differently)."""
    lines = doc.split('\n')
    params: Dict[str, str] = {}
    current_name = None
    current_lines = []
    param_indent = None
    in_section = False

    def flush():
        nonlocal current_name, current_lines
        if current_name is not None:
            params[current_name] = '\n'.join(current_lines)
        current_name = None
        current_lines = []

    for idx, line in enumerate(lines):
        stripped = line.strip()
        if not in_section:
            if stripped == 'Parameters' and idx + 1 < len(lines) and \
                    set(lines[idx + 1].strip()) == {'-'}:
                in_section = True
            continue
        if set(stripped) == {'-'} and stripped:
            if current_name is not None:
                # new section header reached ("Returns\n-------"): the header
                # line was absorbed as a new "param" entry; discard it
                if len(current_lines) == 1 and \
                        current_lines[0].strip().isidentifier():
                    current_name = None
                    current_lines = []
                else:
                    # header absorbed as a trailing description line
                    if current_lines and current_lines[-1].strip().isidentifier():
                        current_lines.pop()
                    flush()
                break
            continue
        if not stripped:
            continue
        indent = len(line) - len(line.lstrip())
        if param_indent is None:
            param_indent = indent
        if indent < param_indent:
            break  # dedent below the section body -> section over
        if indent == param_indent:
            flush()
            current_name = stripped.split(':')[0].strip()
            current_lines = [line]
        else:
            current_lines.append(line)
    flush()
    return params
