"""The port's command-line entry points, run as ``python3 -m dream_tpu_torch.cli.<name>``:
``make_synthetic_dataset``, ``train_network`` and ``network_inference_dataset``,
each with the flags of the JAX package's script of that name plus ``--device``."""
