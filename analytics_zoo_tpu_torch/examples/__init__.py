"""Runnable examples of the port, the ones ported so far. Each module
has ``main(argv)``; run one with
``python -m analytics_zoo_tpu_torch.examples <name> [args...]``. They
run on the card unless given ``--device cpu``."""

EXAMPLES = [
    "lenet_mnist",
    "ncf_recommendation",
    "wide_and_deep",
    "transfer_learning",
    "text_classification",
    "qa_ranker",
    "anomaly_detection",
    "chatbot",
    "object_detection",
    "image_classification",
    "resnet_imagenet",
    "rdd_ingest",
    "inference_serving",
    "quantized_serving",
    "streaming_inference",
    "nnframes_classification",
    "bert_finetune",
    "transformer_sentiment",
    "autograd_custom",
    "vae_mnist",
    "onnx_import",
]
