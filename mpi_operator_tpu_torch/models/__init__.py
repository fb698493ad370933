"""Models of the port (twin of ``mpi_operator_tpu/models/__init__.py``).

Families: mnist (the reference's Horovod MNIST), resnet (tf_cnn_benchmarks
ResNet-101, the headline benchmark) and llama (the flagship decoder). Each
module has ``Config``, ``init(config, generator, device)``, ``apply``,
``loss_fn(model, batch)``, ``logical_axes`` and ``params_from_jax``; its
``nn.Module`` speaks parallel/sharding.py's protocol (``logical_axes``,
``fsdp_units``, ``set_parallel``).

Two families are the port's own, with no JAX twin: afmoe (Arcee's Trinity
models: gated attention, windowed and global, over a dropless top-k MoE
with a shared expert) and deepseek_v3 (DeepSeek-V3 blocks, here Kakao's
Kanana-2: multi-head latent attention, q/k 192 wide and v 128 over a
512-wide latent, over the same MoE with two shared experts). Each has
``Config``, ``init``, ``apply`` and the sharding protocol, trains through
``llama.loss_fn``, and its model's ``after_update`` moves the experts'
balancing bias after each update.
"""

from mpi_operator_tpu_torch.models import afmoe, deepseek_v3, llama, mnist, resnet

# name → (module, config factory); the factory bakes in the depth/preset so
# registry users can't get a module whose default Config contradicts the name
MODELS = {
    "mnist": (mnist, mnist.Config),
    "resnet50": (resnet, lambda: resnet.Config(depth="resnet50")),
    "resnet101": (resnet, lambda: resnet.Config(depth="resnet101")),
    "llama3-8b": (llama, llama.llama3_8b),
    "llama-tiny": (llama, llama.tiny),
    "trinity-mini": (afmoe, afmoe.trinity_mini),
    "afmoe-tiny": (afmoe, afmoe.tiny),
    "kanana-2-30b-a3b": (deepseek_v3, deepseek_v3.kanana_2_30b_a3b),
    "deepseek-v3-tiny": (deepseek_v3, deepseek_v3.tiny),
}
# the names above that the JAX package's registry does not have
PORT_ONLY = ("trinity-mini", "afmoe-tiny", "kanana-2-30b-a3b", "deepseek-v3-tiny")

__all__ = ["afmoe", "deepseek_v3", "mnist", "resnet", "llama", "MODELS", "PORT_ONLY"]
