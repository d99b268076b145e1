"""Model zoo: builder-backed ONNX graphs at the published architectures, with
seeded weights (copy of ``synapseml_tpu/models``)."""

from .zoo import MODEL_BUILDERS, bert_encoder, build_model_bytes, resnet, vit

__all__ = ["MODEL_BUILDERS", "build_model_bytes", "resnet", "bert_encoder", "vit"]
