"""Weight conversion from the JAX package (``convert.py``), checkpoints
(``checkpoint.py``), result files (``results.py``), TensorFlow checkpoint
bundles (``tf_bundle.py``; its protobuf helpers also serve the
``.tfrecords`` reader), the reference TF and torch checkpoint imports
(``import_tf.py``, ``import_torch.py``) and the torch export
(``export_torch.py``)."""
