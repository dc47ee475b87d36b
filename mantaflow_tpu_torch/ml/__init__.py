"""ML toolbox: feature extraction, dataset generation, PyTorch examples.

Port of ``mantaflow_tpu/ml`` (the reference's ``tensorflow/`` tree and
``source/plugin/tfplugins.cpp``): per-particle stencil feature vectors
(extractFeature{Vel,Phi,Geo}), connected-region analysis
(getRegions/getRegionalCounts/extendRegion), a mantaGen-style dataset
generator driving the smoke and FLIP models, and the model examples
(tiled super-resolution, ML-FLIP splash classification, pressure resnet,
autoencoder, GAN) as PyTorch networks. Weights trained by the JAX package
load with ``models.load_flax_params``.
"""

from .features import (extract_feature_vel, extract_feature_phi,
                       extract_feature_geo, get_regions,
                       get_regional_counts, extend_region)
from .datagen import generate_smoke_dataset, generate_flip_dataset
