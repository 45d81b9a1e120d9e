from givepose_torch.eval.serving import (
    export_posenet,
    load_exported,
    load_exported_file,
    save_exported,
    serving_batch_spec,
)
