"""The port's command-line entry points, run as ``python3 -m dream_tpu_torch.cli.<name>``:
``make_synthetic_dataset``, ``train_network``, ``network_inference_dataset``,
``analyze_training``, ``analyze_training_multi``, ``serve_dream``,
``dream_client_example``, ``export_inference`` and the others, each with
the flags of the JAX package's script of that name plus ``--device`` (the
client runs on no device; the export CLI's ``--device`` takes the place of
``--platforms``)."""
