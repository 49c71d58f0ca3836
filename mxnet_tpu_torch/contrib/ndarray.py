"""``mx.contrib.nd`` of the PyTorch port (counterpart of
``mxnet_tpu/contrib/ndarray.py``): the contrib ops live on ``npx``; this
module aliases them, the legacy CamelCase spellings included."""
from .. import numpy_extension as _npx

multibox_prior = _npx.multibox_prior
multibox_target = _npx.multibox_target
multibox_detection = _npx.multibox_detection
deformable_convolution = _npx.deformable_convolution
modulated_deformable_convolution = _npx.modulated_deformable_convolution
hawkesll = _npx.hawkes_ll  # the reference's spelling (contrib/hawkes_ll.cc)
hawkes_ll = _npx.hawkes_ll
round_ste = _npx.round_ste
sign_ste = _npx.sign_ste
khatri_rao = _npx.khatri_rao
quadratic = _npx.quadratic
all_finite = _npx.all_finite
multi_all_finite = _npx.multi_all_finite
multi_sum_sq = _npx.multi_sum_sq
getnnz = _npx.nnz  # the reference's op name (contrib/nnz.cc)
BilinearResize2D = _npx.bilinear_resize_2d
PSROIPooling = _npx.psroi_pooling

# legacy 1.x CamelCase op names
MultiBoxPrior = multibox_prior
MultiBoxTarget = multibox_target
MultiBoxDetection = multibox_detection
DeformableConvolution = deformable_convolution

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "deformable_convolution", "modulated_deformable_convolution",
           "hawkesll", "hawkes_ll", "round_ste", "sign_ste", "khatri_rao",
           "quadratic", "all_finite", "multi_all_finite", "multi_sum_sq",
           "getnnz", "BilinearResize2D", "PSROIPooling",
           "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection",
           "DeformableConvolution"]
