from givepose_torch.data.records import NocsRecordReader, Record
from givepose_torch.data.preprocess import (
    collate_records,
    draw_preprocess,
    dzi_jitter,
    preprocess_batch,
)
from givepose_torch.data.sampler import EpochSampler
from givepose_torch.data.pipeline import TrainPipeline
