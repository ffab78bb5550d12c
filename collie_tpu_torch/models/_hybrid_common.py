"""Shared compute and persistence for the hybrid (metadata) models.

Port of ``collie_tpu/models/_hybrid_common.py``.  ``HybridModel`` and
``HybridPretrainedModel`` share one architecture (reference
``hybrid_matrix_factorization.py:293-546``,
``hybrid_pretrained_matrix_factorization.py:188-464``): optional per-type
metadata MLP towers (leaky ReLU, slope 0.01, then dropout; xavier-normal
init), a combined MLP over
``concat([user_meta], user_emb, item_emb, [item_meta])`` ending in a 1-unit
layer, plus user/item biases.  Persistence is a directory of ``model.npz``
plus ``item_metadata.npy`` / ``user_metadata.npy``, the JAX package's
layout, so a directory written by either package loads in the other.

Metadata lives on the model's device as ``[num_ids, F]`` float32 tensors
and is gathered with ids clamped into its rows.  The gathers, towers and
the concatenation of a score are one ``collie.hybrid.metadata`` span, and
the rows gathered the program counter ``collie.hybrid.metadata_rows``
(``training/profiler.py``).  Dropout masks are drawn
from one generator in the JAX package's program order and at its shapes:
the user tower's layers, the item tower's, then the combined layers'.
"""
import os
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Union

import numpy as np
import pandas as pd
import torch

from collie_tpu_torch.config import DATA_PATH
from collie_tpu_torch.ops.embeddings import dropout, embedding_lookup
from collie_tpu_torch.ops.nn import add_linear, leaky_relu, linear
from collie_tpu_torch.training.profiler import annotate, count


def as_float_array(metadata) -> Optional[np.ndarray]:
    """Normalize tensor / DataFrame / ndarray metadata to a float32 ndarray."""
    if metadata is None:
        return None
    if isinstance(metadata, pd.DataFrame):
        metadata = metadata.to_numpy()
    if isinstance(metadata, torch.Tensor):
        metadata = metadata.detach().cpu().numpy()
    return np.asarray(metadata, dtype=np.float32)


def metadata_tensor(metadata, device) -> Optional[torch.Tensor]:
    """Metadata as a float32 tensor on ``device`` (``None`` stays ``None``)."""
    if metadata is None:
        return None
    if isinstance(metadata, torch.Tensor):
        return metadata.detach().to(device=device, dtype=torch.float32)
    return torch.as_tensor(as_float_array(metadata), device=device)


def build_metadata_tower_params(params: Dict, generator: torch.Generator, metadata_type: str,
                                layers_dims: Optional[List[int]],
                                num_metadata_cols: Optional[int]) -> None:
    """Add ``{type}_metadata_layer_{i}_*`` xavier-normal linears
    (reference ``_configure_metadata_layers``)."""
    if layers_dims is None:
        return
    dims = [num_metadata_cols] + list(layers_dims)
    for i in range(len(dims) - 1):
        add_linear(params, f'{metadata_type}_metadata_layer_{i}', generator,
                   dims[i], dims[i + 1], init='xavier_normal')


def build_combined_params(params: Dict, generator: torch.Generator,
                          combined_dimension_input: int,
                          combined_layers_dims: List[int]) -> int:
    """Add ``combined_layer_{i}_*`` xavier-normal linears ending in 1 unit.
    Returns the layer count."""
    dims = [combined_dimension_input] + list(combined_layers_dims) + [1]
    for i in range(len(dims) - 1):
        add_linear(params, f'combined_layer_{i}', generator, dims[i], dims[i + 1],
                   init='xavier_normal')
    return len(dims) - 1


def metadata_tower_layers(params: Dict, out: torch.Tensor, metadata_type: str,
                          n_layers: int, dropout_p: float, training: bool,
                          generator: Optional[torch.Generator]) -> torch.Tensor:
    """The (optional) metadata MLP over already-gathered rows: per layer a
    linear, leaky ReLU, then dropout (one draw per layer, in layer order)."""
    for i in range(n_layers):
        out = dropout(generator,
                      leaky_relu(linear(params, f'{metadata_type}_metadata_layer_{i}', out)),
                      dropout_p, training)
    return out


def gather_metadata(metadata: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Metadata rows of ``ids`` (any shape), ids clamped into its rows;
    counted in the program counter ``collie.hybrid.metadata_rows``."""
    count('collie.hybrid.metadata_rows', ids.numel())
    return metadata[ids.clamp(0, metadata.shape[0] - 1)]


def metadata_tower_output(params: Dict, metadata: torch.Tensor, ids: torch.Tensor,
                          metadata_type: str, n_layers: int, dropout_p: float,
                          training: bool, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Gather metadata rows and run them through the (optional) tower
    (reference ``_compute_metadata_output``)."""
    return metadata_tower_layers(params, gather_metadata(metadata, ids), metadata_type,
                                 n_layers, dropout_p, training, generator)


def combined_prediction(params: Dict, combined: torch.Tensor, user_biases: torch.Tensor,
                        item_biases: torch.Tensor, n_combined_layers: int,
                        dropout_p: float, training: bool,
                        generator: Optional[torch.Generator]) -> torch.Tensor:
    """Combined MLP -> 1 unit + biases (reference ``_compute_prediction``)."""
    out = combined
    for i in range(n_combined_layers - 1):
        out = dropout(generator, leaky_relu(linear(params, f'combined_layer_{i}', out)),
                      dropout_p, training)
    return (linear(params, f'combined_layer_{n_combined_layers - 1}', out)[..., 0]
            + user_biases + item_biases)


def hybrid_score(model, params, users, items, training, generator,
                 detach_embeddings: bool = False) -> torch.Tensor:
    """The metadata architecture's pairwise score of ``users`` and ``items``
    (same shape): towers, combined MLP and biases.  ``detach_embeddings``
    gives the embedding tables no gradient (frozen tables)."""
    p = model.hparams.get('dropout_p', 0.0)
    user_emb = embedding_lookup(params['user_embeddings'], users)
    item_emb = embedding_lookup(params['item_embeddings'], items)
    if detach_embeddings:
        user_emb, item_emb = user_emb.detach(), item_emb.detach()
    with annotate('collie.hybrid.metadata'):
        pieces = []
        if model.user_metadata is not None:
            pieces.append(metadata_tower_output(
                params, model.user_metadata, users, 'user', model._n_meta_layers('user'), p,
                training, generator))
        pieces += [user_emb, item_emb]
        if model.item_metadata is not None:
            pieces.append(metadata_tower_output(
                params, model.item_metadata, items, 'item', model._n_meta_layers('item'), p,
                training, generator))
        combined = torch.cat(pieces, dim=-1)
    return combined_prediction(params, combined,
                               params['user_biases'][users], params['item_biases'][items],
                               model.n_combined_layers, p, training, generator)


def hybrid_pairwise_scores(model, params, users, items, training, generator,
                           detach_embeddings: bool = False) -> torch.Tensor:
    """Tile-after-gather pairwise scoring ``[B] users x [R, B] items ->
    [R, B]`` for the metadata architectures.

    Each user-side table (embedding rows, metadata rows, biases) is
    gathered once as ``[B, .]`` and broadcast to ``[R, B, .]``; item-side
    gathers keep the ``[R, B]`` ids, and the towers and combined MLP run at
    ``[R, B, .]``, so every dropout mask is drawn at ``[R, B, h]`` as in the
    JAX package.  Outputs equal the tiled ``score`` path's element for
    element."""
    R, B = items.shape
    p = model.hparams.get('dropout_p', 0.0)
    user_emb = embedding_lookup(params['user_embeddings'], users)     # [B, D]
    item_emb = embedding_lookup(params['item_embeddings'], items)     # [R, B, D]
    if detach_embeddings:
        user_emb, item_emb = user_emb.detach(), item_emb.detach()

    with annotate('collie.hybrid.metadata'):
        pieces = []
        if model.user_metadata is not None:
            rows = gather_metadata(model.user_metadata, users)        # [B, F]
            pieces.append(metadata_tower_layers(
                params, rows[None].expand((R,) + rows.shape), 'user',
                model._n_meta_layers('user'), p, training, generator))
        pieces.append(user_emb[None].expand((R,) + user_emb.shape))
        pieces.append(item_emb)
        if model.item_metadata is not None:
            pieces.append(metadata_tower_output(
                params, model.item_metadata, items, 'item', model._n_meta_layers('item'), p,
                training, generator))
        combined = torch.cat(pieces, dim=-1)
    return combined_prediction(params, combined,
                               params['user_biases'][users][None, :],
                               params['item_biases'][items],
                               model.n_combined_layers, p, training, generator)


def save_hybrid_model(model, path: Union[str, Path], overwrite: bool) -> None:
    """Directory save: ``model.npz`` plus metadata ``.npy`` files
    (reference ``hybrid_matrix_factorization.py:558-595``)."""
    from collie_tpu_torch.models.base import BasePipeline

    path = str(path)
    if os.path.exists(path) and os.listdir(path) and overwrite is False:
        raise ValueError(f'Data exists in ``path`` at {path} and ``overwrite`` is False.')
    Path(path).mkdir(parents=True, exist_ok=True)
    if model.item_metadata is not None:
        np.save(os.path.join(path, 'item_metadata.npy'), model.item_metadata.cpu().numpy())
    if model.user_metadata is not None:
        np.save(os.path.join(path, 'user_metadata.npy'), model.user_metadata.cpu().numpy())
    # the base npz of the params, which never hold a pretrained donor model
    BasePipeline.save_model(model, os.path.join(path, 'model.npz'))


def load_hybrid_metadata(model, load_model_path: Union[str, Path]) -> None:
    """Restore metadata arrays from a hybrid save directory onto the model's
    device."""
    load_model_path = str(load_model_path)
    item_path = os.path.join(load_model_path, 'item_metadata.npy')
    user_path = os.path.join(load_model_path, 'user_metadata.npy')
    if os.path.exists(item_path):
        model.item_metadata = metadata_tensor(np.load(item_path), model._device)
    elif model.hparams.get('item_metadata_layers_dims') is not None:
        warnings.warn('``item_metadata.npy`` not found')
    if os.path.exists(user_path):
        model.user_metadata = metadata_tensor(np.load(user_path), model._device)
    elif model.hparams.get('user_metadata_layers_dims') is not None:
        warnings.warn('``user_metadata.npy`` not found')


class HybridMixin:
    """What ``HybridModel`` and ``HybridPretrainedModel`` share besides the
    functions above: metadata installation, the tower and combined layers'
    construction, and the directory save and load."""

    def _install_metadata(self, item_metadata=None, user_metadata=None, **_) -> None:
        """Metadata given to the constructor, on the model's device."""
        if item_metadata is not None:
            self.item_metadata = metadata_tensor(item_metadata, self._device)
        if user_metadata is not None:
            self.user_metadata = metadata_tensor(user_metadata, self._device)

    def _add_metadata_and_combined_params(self, params: Dict, generator: torch.Generator,
                                          embeddings_width: int) -> None:
        """The item tower, the user tower, then the combined layers over the
        embeddings (``embeddings_width`` wide) and the towers' outputs."""
        widths = []
        for metadata_type in ('item', 'user'):
            layers_dims = self.hparams.get(f'{metadata_type}_metadata_layers_dims')
            num_cols = self.hparams.get(f'{metadata_type}_metadata_num_cols')
            build_metadata_tower_params(params, generator, metadata_type, layers_dims, num_cols)
            widths.append(layers_dims[-1] if layers_dims is not None else num_cols)
        build_combined_params(params, generator, embeddings_width + sum(w or 0 for w in widths),
                              self.hparams['combined_layers_dims'])

    @property
    def n_combined_layers(self) -> int:
        return len(self.hparams['combined_layers_dims']) + 1

    def _n_meta_layers(self, metadata_type: str) -> int:
        dims = self.hparams.get(f'{metadata_type}_metadata_layers_dims')
        return len(dims) if dims is not None else 0

    def _get_item_embeddings(self) -> torch.Tensor:
        return self.params['item_embeddings']

    def _get_user_embeddings(self) -> torch.Tensor:
        return self.params['user_embeddings']

    def save_model(self, path=str(DATA_PATH / 'model'), overwrite: bool = False) -> None:
        """Directory save (reference ``hybrid_matrix_factorization.py:558-595``,
        ``hybrid_pretrained_matrix_factorization.py:486-534``)."""
        save_hybrid_model(self, path, overwrite)

    def _load_model_init_helper(self, load_model_path, **kwargs) -> None:
        """The directory's ``model.npz``, then its metadata; metadata given
        to the constructor takes their place."""
        super()._load_model_init_helper(
            load_model_path=os.path.join(str(load_model_path), 'model.npz'), **kwargs)
        load_hybrid_metadata(self, load_model_path)
        self._install_metadata(**kwargs)
