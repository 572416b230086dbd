"""Runnable flowgraphs of the port, each the twin of one of the JAX
package's ``examples/`` and asserting what it asserts. Each has a
``main(device="cuda")``: ``python3 -m newsched_tpu_torch.examples.<name>``
runs it on the card, the tests call ``main("cpu")``. ``yaml_block`` needs
PyYAML, so it runs on the CPU only."""
