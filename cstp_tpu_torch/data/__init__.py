"""Host data layer of the port: the video readers (synthetic, frame-dir,
CSTPack, LMDB, video files), the pretrain and finetune loaders and the
prefetch onto the device."""
