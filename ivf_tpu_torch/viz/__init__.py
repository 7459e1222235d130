"""Result rendering of the port (port of ``ivf_tpu/viz``): the per-clip
images, GIFs and mask files that ``find_masks(..., save_viz=True)``
writes, and the training curves (``PlotLearning``). Numpy and Pillow
only: no cv2, no matplotlib."""

from ivf_tpu_torch.viz.render import (
    PlotLearning,
    create_image_arrays,
    find_temp_mask_dots,
    image_panels,
    visualize_results,
    visualize_results_on_gradcam,
)

__all__ = [
    "visualize_results",
    "visualize_results_on_gradcam",
    "find_temp_mask_dots",
    "create_image_arrays",
    "image_panels",
    "PlotLearning",
]
