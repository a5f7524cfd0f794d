"""Host data layer of the port: the video readers (synthetic, frame-dir,
CSTPack in Python and in C++, LMDB, video files), the pretrain and finetune
loaders and the prefetch onto the device, and the offline tools
(``extract_frames``, ``pack``, the LMDB writers)."""
