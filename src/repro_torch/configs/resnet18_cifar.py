"""The paper's own deployed-model family (ResNet-18 on CIFAR-10-like tasks).
Used by the accuracy evaluation (``repro_torch.eval.unavailability``); see
``repro_torch.models.cnn``."""
PAPER_MODELS = {
    # name: (kind, hidden sizes / stages, num classes)
    "mlp": ("mlp", (200, 100), 10),          # the paper's 2-hidden-layer MLP
    "lenet5": ("cnn", (6, 16), 10),          # LeNet-5-style
    "resnet18s": ("resnet", (16, 32, 64), 10),  # small ResNet for CIFAR-size inputs
}
IMAGE_SHAPE = (32, 32, 3)
