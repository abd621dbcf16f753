"""Zero-egress quality yardsticks through the port: the shapes dataset
(make_shapes_dataset.py), the pose and identity scorer (shapes_score.py),
the digits scorer (digits_score.py) and the numpy MLPs they fit (mlp.py).
The repo's tools/ drive the JAX package; these drive the port."""
