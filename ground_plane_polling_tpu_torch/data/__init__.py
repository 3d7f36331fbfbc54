"""Host-side data: KITTI images and calibration, the plane database, and
frame preparation for inference."""
