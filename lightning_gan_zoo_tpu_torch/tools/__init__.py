"""Zero-egress quality yardsticks through the port: the shapes dataset
(make_shapes_dataset.py), the pose and identity scorer (shapes_score.py),
the digits scorer with the 1,797 digits it trains on (digits_score.py,
digits.npz) and the numpy MLPs they fit (mlp.py). The repo's tools/ drive
the JAX package; these drive the port, without scikit-learn."""
