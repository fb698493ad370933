"""Models of the port (twin of ``mpi_operator_tpu/models/__init__.py``).

Families: mnist (the reference's Horovod MNIST), resnet (tf_cnn_benchmarks
ResNet-101, the headline benchmark) and llama (the flagship decoder). Each
module has ``Config``, ``init(config, generator, device)``, ``apply``,
``loss_fn(model, batch)``, ``logical_axes`` and ``params_from_jax``; its
``nn.Module`` speaks parallel/sharding.py's protocol (``logical_axes``,
``fsdp_units``, ``set_parallel``).
"""

from mpi_operator_tpu_torch.models import llama, mnist, resnet

# name → (module, config factory); the factory bakes in the depth/preset so
# registry users can't get a module whose default Config contradicts the name
MODELS = {
    "mnist": (mnist, mnist.Config),
    "resnet50": (resnet, lambda: resnet.Config(depth="resnet50")),
    "resnet101": (resnet, lambda: resnet.Config(depth="resnet101")),
    "llama3-8b": (llama, llama.llama3_8b),
    "llama-tiny": (llama, llama.tiny),
}

__all__ = ["mnist", "resnet", "llama", "MODELS"]
