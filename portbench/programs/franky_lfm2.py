"""The program's FrankyLfm2 as the benchmark serves it: Franky's brain
encoder feeding LFM2-8B-A1B, built in bfloat16 on the device and loaded
with the benchmark's weights, behind the same predictor as Franky. Its
plain twin is ``reference/franky_lfm2.py``."""

from __future__ import annotations

from portbench import weights
from portbench.programs import franky as franky_program
from portbench.reference import franky_lfm2 as ref

serving_pool = franky_program.serving_pool


def build_serving(spec, seed: int, device: str):
    """(model, predictor, the model's parameter names and shapes) for the
    cell. The model is laid out on the meta device, given bfloat16 storage
    on the card and filled with the benchmark's weights (drawn from the
    seed in bfloat16), so no float32 copy of its 8.3B parameters exists."""
    import torch
    from frankenstein_tpu_torch.config import FrankyLfm2Config
    from frankenstein_tpu_torch.data.tokenizers import ByteTokenizer
    from frankenstein_tpu_torch.decode import pipeline
    from frankenstein_tpu_torch.models.franky import FrankyLfm2
    mc, tr = spec.config["model_config"], spec.traffic
    model = FrankyLfm2(FrankyLfm2Config.from_dict(mc), device="meta")
    shapes = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    model = pipeline.cast_params_for_inference(model).to_empty(
        device=torch.device(device))
    weights.load(model, weights.make(shapes, ref.init_rule, seed, device,
                                     torch.bfloat16, ref.n_layer(mc)))
    predict = pipeline.make_franky_predictor(
        model, ByteTokenizer(), max_new_tokens=tr["max_new_tokens"],
        top_k=tr.get("top_k"), beam_width=tr.get("beam_width", 0),
        int8_weights=tr.get("int8_weights", False),
        int8_kv=tr.get("int8_kv", False), eot_id=ref.EOT, seed=seed)
    return model, predict, shapes
