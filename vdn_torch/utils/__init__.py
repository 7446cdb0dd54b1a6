"""Host helpers: video frame IO and point clouds."""
