"""Whole-slide image access.  Only the slide property names are ported so
far (OpenSlide's, as the JAX package's ``wsi`` names them); the slide
readers come with the end-to-end slice."""

PROPERTY_NAME_MPP_X = "openslide.mpp-x"
PROPERTY_NAME_MPP_Y = "openslide.mpp-y"
PROPERTY_NAME_OBJECTIVE_POWER = "openslide.objective-power"
