#!/usr/bin/env python
"""ROS1 live-input nodes on the PyTorch port (the reference's Examples/ROS/ORB_SLAM3/src/:
ros_mono.cc, ros_stereo.cc, ros_rgbd.cc, ros_mono_inertial.cc,
ros_stereo_inertial.cc — all five sensor modes on live topics).

Usage:
  python examples/run_ros_torch.py SETTINGS.yaml --mode mono|stereo|rgbd|mono_vi|stereo_vi \
      [--image /cam0/image_raw] [--image-right /cam1/image_raw] \
      [--depth /camera/depth_registered/image_raw] [--imu /imu0] [--out traj.txt] \
      [--device cuda|cpu]

Requires rospy + cv_bridge on the PYTHONPATH (a ROS1 environment); exits
with a clear message otherwise. The SLAM side is identical to the dataset
drivers — topics feed track_* exactly as the reference's GrabImage callbacks
feed System::Track* (reference ros_stereo_inertial.cc:39-59,145,196).
"""
import argparse
import sys

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from orbslam3_tpu_torch.utils.config import system_from_config  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("settings")
    ap.add_argument("--mode", default="mono",
                    choices=["mono", "stereo", "rgbd", "mono_vi", "stereo_vi"])
    ap.add_argument("--image", default="/cam0/image_raw")
    ap.add_argument("--image-right", default="/cam1/image_raw")
    ap.add_argument("--depth", default="/camera/depth_registered/image_raw")
    ap.add_argument("--imu", default="/imu0")
    ap.add_argument("--out", default="trajectory_ros.txt")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    try:
        import rospy
        from cv_bridge import CvBridge
        from sensor_msgs.msg import Image, Imu
        import message_filters
    except ImportError:
        print("run_ros_torch.py needs a ROS1 environment (rospy, cv_bridge, "
              "sensor_msgs, message_filters on PYTHONPATH). Source your ROS "
              "setup.bash and retry; for dataset replay without ROS use "
              "run_euroc_torch.py / run_tum_vi_torch.py / run_kitti_torch.py / "
              "run_tum_rgbd_torch.py.",
              file=sys.stderr)
        return 2

    import threading
    from collections import deque

    slam = system_from_config(args.settings, device=args.device)
    bridge = CvBridge()
    inertial = args.mode.endswith("_vi")

    def to_gray(msg):
        img = bridge.imgmsg_to_cv2(msg, desired_encoding="mono8")
        return img.astype(np.float32)

    # Inertial modes mirror the reference's ImageGrabber/ImuGrabber +
    # SyncWithImu pattern (reference ros_mono_inertial.cc): callbacks only
    # BUFFER under locks; one sync thread tracks an image after the newest
    # buffered IMU timestamp has passed it, feeding the tracker's IMU queue
    # from that single thread (grab_imu / _preintegrate_frame are not
    # concurrent-safe against rospy's callback threads).
    imu_lock = threading.Lock()
    imu_buf: deque = deque()
    img_lock = threading.Lock()
    img_buf: deque = deque(maxlen=8)
    finish = threading.Event()

    def on_imu(msg):
        g = msg.angular_velocity
        a = msg.linear_acceleration
        with imu_lock:
            imu_buf.append((msg.header.stamp.to_sec(),
                            np.asarray([g.x, g.y, g.z], np.float32),
                            np.asarray([a.x, a.y, a.z], np.float32)))

    def track(kind, payload, ts):
        if kind == "mono":
            slam.track_monocular(payload[0], ts)
        elif kind == "stereo":
            if slam.tracker.rig is not None:
                slam.track_stereo_fisheye(payload[0], payload[1], ts)
            else:
                slam.track_stereo(payload[0], payload[1], ts)
        else:
            slam.track_rgbd(payload[0], payload[1], ts)

    def sync_loop():
        import time
        while not finish.is_set():
            item = None
            with img_lock:
                if img_buf:
                    ts = img_buf[0][2]
                    with imu_lock:
                        imu_ready = bool(imu_buf) and imu_buf[-1][0] >= ts
                    if imu_ready:
                        item = img_buf.popleft()
            if item is None:
                time.sleep(0.002)
                continue
            kind, payload, ts = item
            with imu_lock:
                take = []
                while imu_buf and imu_buf[0][0] <= ts + 1e-6:
                    take.append(imu_buf.popleft())
            for (t_i, g_i, a_i) in take:
                slam.tracker.grab_imu(np.asarray([t_i]), g_i[None], a_i[None])
            track(kind, payload, ts)

    def dispatch(kind, payload, ts):
        if inertial:
            with img_lock:
                img_buf.append((kind, payload, ts))
        else:
            track(kind, payload, ts)

    def on_mono(msg):
        dispatch("mono", (to_gray(msg),), msg.header.stamp.to_sec())

    def on_stereo(msg_l, msg_r):
        dispatch("stereo", (to_gray(msg_l), to_gray(msg_r)),
                 msg_l.header.stamp.to_sec())

    def on_rgbd(msg_rgb, msg_d):
        depth = bridge.imgmsg_to_cv2(msg_d, desired_encoding="passthrough")
        dispatch("rgbd", (to_gray(msg_rgb), np.asarray(depth, np.float32)),
                 msg_rgb.header.stamp.to_sec())

    rospy.init_node("orbslam3_tpu_torch", anonymous=True)
    subs = []
    sync_thread = None
    if inertial:
        subs.append(rospy.Subscriber(args.imu, Imu, on_imu, queue_size=1000))
        sync_thread = threading.Thread(target=sync_loop, name="sync-with-imu",
                                       daemon=True)
        sync_thread.start()
    if args.mode.startswith("mono"):
        subs.append(rospy.Subscriber(args.image, Image, on_mono, queue_size=4))
    elif args.mode.startswith("stereo"):
        sl = message_filters.Subscriber(args.image, Image)
        sr = message_filters.Subscriber(args.image_right, Image)
        sync = message_filters.ApproximateTimeSynchronizer([sl, sr], 10, 0.01)
        sync.registerCallback(on_stereo)
        subs.append(sync)
    else:  # rgbd
        si = message_filters.Subscriber(args.image, Image)
        sd = message_filters.Subscriber(args.depth, Image)
        sync = message_filters.ApproximateTimeSynchronizer([si, sd], 10, 0.05)
        sync.registerCallback(on_rgbd)
        subs.append(sync)

    print(f"orbslam3_tpu_torch ROS node up ({args.mode}); ctrl-c to finish")
    try:
        rospy.spin()
    except KeyboardInterrupt:
        pass
    finish.set()
    if sync_thread is not None:
        sync_thread.join(5.0)
    slam.save_trajectory_tum(args.out)
    print("stats:", slam.stats())
    slam.shutdown(print_times=False)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
