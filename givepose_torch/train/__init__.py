from givepose_torch.train.adam import ClippedAdam
from givepose_torch.train.ranger import Ranger, ranger
from givepose_torch.train.schedule import flat_and_anneal
from givepose_torch.train.step import (
    TrainOptimizer,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)
