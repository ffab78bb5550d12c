"""End-to-end MovieLens example CLI.

Port of ``collie_tpu/movielens/run.py`` (reference
``collie/movielens/run.py:13-81``, whose CLI uses ``fire``; this one is
argparse): read -> implicit conversion -> stratified 80/10/10 split -> MF
(dim 10, ``loss='adaptive'``, lr 5e-2, adam, weight decay 1e-7, dropout
0.05) -> train with early stopping on val loss -> evaluate AUC / MRR /
MAP@10 -> save.  The model lives on the CUDA device unless
``map_location`` names another (``'cpu'``).

Run:  python -m collie_tpu_torch.movielens.run --epochs 20
"""
import argparse

from collie_tpu_torch.config import DATA_PATH
from collie_tpu_torch.data import Interactions, InteractionsDataLoader, stratified_split
from collie_tpu_torch.evaluate import evaluate_in_batches
from collie_tpu_torch.models.matrix_factorization import MatrixFactorizationModel
from collie_tpu_torch.movielens.get_data import read_movielens_df
from collie_tpu_torch.ops import auc, mapk, mrr
from collie_tpu_torch.training.trainer import CollieTrainer
from collie_tpu_torch.utils import Timer, convert_to_implicit


def run_movielens_example(epochs: int = 20,
                          gpus: int = 0,
                          synthetic_fallback: bool = None,
                          map_location: str = None) -> None:
    """Retrieve and split data, train and evaluate a model, and save it
    (reference ``run.py:13-77``).  ``gpus`` is accepted for API parity and
    ignored: the device is ``map_location``'s (``None``: the CUDA device)."""
    t = Timer()

    t.timecheck('  1.0 - retrieving MovieLens 100K dataset')
    df = read_movielens_df(decrement_ids=True, synthetic_fallback=synthetic_fallback)
    t.timecheck('  1.0 complete')

    t.timecheck('  2.0 - splitting data')
    df_imp = convert_to_implicit(df)
    interactions = Interactions(users=df_imp['user_id'],
                                items=df_imp['item_id'],
                                allow_missing_ids=True)
    train, val, test = stratified_split(interactions, val_p=0.1, test_p=0.1)
    train_loader = InteractionsDataLoader(train, batch_size=1024, shuffle=True)
    val_loader = InteractionsDataLoader(val, batch_size=1024, shuffle=False)
    t.timecheck('  2.0 complete')

    t.timecheck('  3.0 - training the model')
    model = MatrixFactorizationModel(train=train_loader,
                                     val=val_loader,
                                     dropout_p=0.05,
                                     loss='adaptive',
                                     lr=5e-2,
                                     embedding_dim=10,
                                     optimizer='adam',
                                     weight_decay=1e-7,
                                     map_location=map_location)
    trainer = CollieTrainer(model=model,
                            max_epochs=epochs,
                            deterministic=True,
                            early_stopping_patience=3)
    trainer.fit(model)
    t.timecheck('\n  3.0 complete')

    t.timecheck('  4.0 - evaluating model')
    auc_score, mrr_score, mapk_score = evaluate_in_batches([auc, mrr, mapk], test, model,
                                                           k=10)
    print(f'AUC:          {auc_score}')
    print(f'MRR:          {mrr_score}')
    print(f'MAP@10:       {mapk_score}')
    t.timecheck('  4.0 complete')

    t.timecheck('  5.0 - saving model')
    model.save_model(DATA_PATH / 'fitted_model' / 'model.npz')
    t.timecheck('  5.0 complete')


def main() -> None:
    parser = argparse.ArgumentParser(description=run_movielens_example.__doc__)
    parser.add_argument('--epochs', type=int, default=20)
    parser.add_argument('--gpus', type=int, default=0)
    parser.add_argument('--synthetic-fallback', action='store_true', default=None,
                        help='Use a synthetic ML-100K stand-in when offline')
    parser.add_argument('--map-location', default=None,
                        help="Device of the model ('cpu'); the CUDA device by default")
    args = parser.parse_args()
    run_movielens_example(epochs=args.epochs, gpus=args.gpus,
                          synthetic_fallback=args.synthetic_fallback,
                          map_location=args.map_location)


if __name__ == '__main__':
    main()
