"""Multi-stage pipelines: per-stage optimizers over parameter-prefix groups.

Port of ``collie_tpu/models/multi_stage.py`` (reference
``collie/model/base/multi_stage_pipeline.py:20-257``): models train in
ordered stages, each with its own optimizer(s) restricted to name-prefixed
parameter groups; only optimizers whose ``stage`` matches the model's
current stage step (``:226-257``), and ``score`` may switch on the stage.

Trainer integration is ``OptimizerSpec.stage``: ``CollieTrainer.fit`` trains
only the active-stage specs' params, so inactive tables come out of a fit
unchanged, and optimizer state resets with each ``fit``.  Loading a saved
multi-stage model jumps to the final stage (``:129-134``).  The port keeps no
compiled or cached scoring function, so a stage change needs no
invalidation: every score reads the stage when it runs.
"""
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Union

from collie_tpu_torch.models.base import INTERACTIONS_LIKE_INPUT, BasePipeline
from collie_tpu_torch.training.optimizers import OptimizerSpec, build_transform
from collie_tpu_torch.training.profiler import annotate
from collie_tpu_torch.utils import get_init_arguments, merge_docstrings


class MultiStagePipeline(BasePipeline):
    """Abstract staged pipeline.

    Parameters
    ----------
    optimizer_config_list: list of dict
        Ordered stage progression; each dict holds ``lr``, ``optimizer``,
        ``parameter_prefix_list`` and ``stage``.
    """

    def __init__(self,
                 train: INTERACTIONS_LIKE_INPUT = None,
                 val: INTERACTIONS_LIKE_INPUT = None,
                 lr_scheduler_func: Optional[Callable] = None,
                 weight_decay: float = 0.0,
                 optimizer_config_list: Optional[List[Dict]] = None,
                 loss: Union[str, Callable] = 'hinge',
                 metadata_for_loss: Optional[Dict] = None,
                 metadata_for_loss_weights: Optional[Dict[str, float]] = None,
                 load_model_path: Optional[str] = None,
                 map_location: Optional[str] = None,
                 **kwargs):
        stage_list = None
        if load_model_path is None:
            if optimizer_config_list is None:
                raise ValueError(
                    'Must provide ``optimizer_config_list`` when initializing a new '
                    'multi-stage model!'
                )
            stage_list = list(OrderedDict.fromkeys(
                config['stage'] for config in optimizer_config_list))

        super().__init__(stage_list=stage_list, **get_init_arguments())

        if load_model_path is None:
            self.hparams['stage'] = self.hparams['stage_list'][0]
            self.set_stage(self.hparams['stage'])

    __doc__ = merge_docstrings(BasePipeline, __doc__, __init__)

    def _load_model_init_helper(self, *args, **kwargs) -> None:
        super()._load_model_init_helper(*args, **kwargs)
        # loading jumps to the final stage (reference ``:129-134``)
        self.hparams['stage'] = self.hparams['stage_list'][-1]
        print(f'Set ``stage`` to "{self.hparams["stage"]}"')

    @property
    def current_stage(self) -> Optional[str]:
        return self.hparams.get('stage')

    def advance_stage(self) -> None:
        """Advance to the next stage in ``stage_list`` (reference ``:136-145``)."""
        stage = self.hparams['stage']
        stage_list = self.hparams['stage_list']
        if stage in stage_list:
            stage_idx = stage_list.index(stage)
            if stage_idx + 1 >= len(stage_list):
                raise ValueError(f'Cannot advance stage past {stage} - it is the final stage!')
            self.set_stage(stage_list[stage_idx + 1])

    def set_stage(self, stage: str) -> None:
        """Jump to a stage (reference ``:147-155``), a ``collie.fit.stage``
        span.  Subclasses hook transitions (e.g. cold-start weight copying)
        by overriding."""
        with annotate('collie.fit.stage'):
            stage_list = self.hparams['stage_list']
            if stage not in stage_list:
                raise ValueError(
                    f'{stage} is not a valid stage, please choose one of {stage_list}'
                )
            self.hparams['stage'] = stage
            print(f'Set ``stage`` to "{stage}"')

    def optimizer_specs(self) -> List[OptimizerSpec]:
        """One spec per optimizer config, owning the params matching its
        prefix list, named ``"{stage}:{index}"`` (reference ``:157-224``);
        a config that matches no param gives no spec."""
        weight_decay = self.hparams.get('weight_decay', 0.0)
        specs = []
        for idx, config in enumerate(self.hparams['optimizer_config_list']):
            keys = [
                name for name in sorted(self.params.keys())
                if any(name.startswith(prefix) for prefix in config['parameter_prefix_list'])
            ]
            if not keys:
                continue
            specs.append(OptimizerSpec(
                name=f"{config['stage']}:{idx}",
                transform=build_transform(config['optimizer'], config['lr'], weight_decay),
                keys=keys,
                stage=config['stage'],
            ))
        return specs
