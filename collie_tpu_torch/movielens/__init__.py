"""MovieLens 100K dataset module, example CLI, and visualizations."""
from collie_tpu_torch.movielens.get_data import (get_movielens_metadata,
                                                 get_user_metadata,
                                                 read_movielens_df,
                                                 read_movielens_df_item,
                                                 read_movielens_df_user,
                                                 read_movielens_posters_df)
from collie_tpu_torch.movielens.run import run_movielens_example
from collie_tpu_torch.movielens.visualize import get_recommendation_visualizations

__all__ = [
    'get_movielens_metadata', 'get_recommendation_visualizations', 'get_user_metadata',
    'read_movielens_df', 'read_movielens_df_item', 'read_movielens_df_user',
    'read_movielens_posters_df', 'run_movielens_example',
]
