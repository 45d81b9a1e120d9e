from givepose_torch.eval.metrics import (
    pairwise_3d_iou,
    pairwise_degree_cm,
    voc_ap,
    SYNSET_NAMES,
)
from givepose_torch.eval.harness import (
    compute_degree_cm_map,
    scale_normalize_results,
    summarize,
)
from givepose_torch.eval.load_eval import (
    NocsEvalReader,
    WildEvalReader,
    build_instance_batch,
)
from givepose_torch.eval.evaluate import (
    run_inference,
    evaluate_results,
    make_inference_fn,
)
from givepose_torch.eval.serving import (
    export_posenet,
    load_exported,
    load_exported_file,
    save_exported,
    serving_batch_spec,
)
