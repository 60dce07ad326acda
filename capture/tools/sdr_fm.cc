// Host-side demodulator — rtl_fm.c capability: stream (or read a file
// of) u8 IQ, demodulate (FM discriminator, AM envelope, USB/LSB phasing,
// or raw passthrough), decimate, de-emphasize, and write s16 audio. The
// accelerator path (tdoa_tpu.dsp.fm) is the
// production demod; this tool covers the reference's standalone-
// listening use and gives the capture stack a pure-native smoke path.
// Pipeline mirrors rtl_fm's stages: polar_discriminant (rtl_fm.c:427-434)
// / am_demod (546-561) / usb_demod+lsb_demod phasing sums (563-587) →
// low-pass decimation (302-322) → de-emphasis (596) → DC block (613).
//
// Squelch + scanning (rtl_fm.c:186-189, 1262-1282): multiple -f
// arguments (ranges "low:high:step" supported, k/M/G suffixes) build a
// scan list; when the squelch (-l, RMS in u8 counts) stays closed for
// -t consecutive blocks the tool retunes to the next list entry.
// Negative -t exits on squelch instead (rtl_fm.c:1087-1093).
// -M wbfm expands to "-s 170k -r 32k -l 0 -E deemp" (rtl_fm.c:1123-1137).
//
// Live input runs DECOUPLED, like the reference's 4-thread pipeline
// (rtl_fm.c:806-841 dongle/demod/output threads): the USB dispatch
// thread only measures squelch RMS, makes scan-hop decisions (device
// control calls stay on the dispatch thread, the same serialization
// the 2-freq capture engine relies on) and enqueues raw blocks; a
// demod thread runs the discriminator/Hilbert math; a writer thread
// owns the output file — so a stalling disk/pipe or an underpowered
// host never blocks the USB engine. Queues are bounded: the audio
// queue backpressures the demod thread, the IQ queue drops newest
// blocks with an honest count (the reference's ring overwrites
// silently, rtl_fm.c:832-838).
//
//   sdr_fm [-M fm|wbfm|am|usb|lsb|raw] [-s rate] [-r audio_rate]
//          [-d deemph_us] [-l squelch] [-t squelch_delay] [-g gain_db]
//          [-p ppm] [-E edge|dc|deemp|direct|offset]
//          (-i in.iq | --live seconds) [-f freq_or_range]... out.raw
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "sdrcap/args.h"
#include "sdrcap/backend.h"
#include "sdrcap/device.h"

namespace {

enum class Mode { kFm, kAm, kUsb, kLsb, kRaw };

struct Demod {
  Mode mode = Mode::kFm;
  double prev_re = 1.0, prev_im = 0.0;
  double deemph_state = 0.0, dc_avg = 0.0;
  double deemph_alpha = 0.0;
  int decim = 16;
  int acc_n = 0;
  double acc_v = 0.0, acc_re = 0.0, acc_im = 0.0;
  // SSB phasing-method state: Hilbert FIR over decimated Q, with I
  // delayed to the filter's group-delay center. Length scales with the
  // audio rate so rejection holds down to ~150 Hz at any decimation.
  int hilbert_taps = 255;
  std::vector<double> htaps;
  std::vector<double> ssb_i, ssb_q;  // rings, size hilbert_taps
  uint64_t ssb_n = 0;

  void configure(Mode mode_, double fs, int decim_, double deemph_us) {
    mode = mode_;
    decim = decim_;
    deemph_alpha =
        deemph_us > 0 ? 1.0 - std::exp(-1.0 / (fs / decim * deemph_us * 1e-6))
                      : 0.0;
    if (mode == Mode::kUsb || mode == Mode::kLsb) {
      // Transition band of the Hann-windowed transformer ≈ 4·fs/T;
      // target ~150 Hz at the audio rate, clamped odd in [255, 4095].
      const double fs_audio = fs / decim;
      int t = (int)(4.0 * fs_audio / 150.0);
      t = std::max(255, std::min(4095, t)) | 1;
      hilbert_taps = t;
      htaps.assign(hilbert_taps, 0.0);
      ssb_i.assign(hilbert_taps, 0.0);
      ssb_q.assign(hilbert_taps, 0.0);
      // Hann-windowed ideal Hilbert transformer: h[m]=2/(pi m), odd m.
      const int c = (hilbert_taps - 1) / 2;
      for (int k = 0; k < hilbert_taps; ++k) {
        const int m = k - c;
        if (m % 2 != 0) {
          const double w =
              0.5 - 0.5 * std::cos(2.0 * M_PI * k / (hilbert_taps - 1));
          htaps[k] = 2.0 / (M_PI * m) * w;
        }
      }
    }
  }

  // Clear stream state across a scan retune so the discriminator and
  // filters don't splice two unrelated signals together.
  void reset() {
    prev_re = 1.0;
    prev_im = 0.0;
    deemph_state = dc_avg = 0.0;
    acc_n = 0;
    acc_v = acc_re = acc_im = 0.0;
    std::fill(ssb_i.begin(), ssb_i.end(), 0.0);
    std::fill(ssb_q.begin(), ssb_q.end(), 0.0);
    ssb_n = 0;
  }

  // Consume one IQ sample; returns true + fills `out` when an audio
  // sample is ready.
  bool push(double re, double im, int16_t* out) {
    if (mode == Mode::kFm) {
      // Discriminator: angle of x[n] * conj(x[n-1]).
      const double pr = re * prev_re + im * prev_im;
      const double pi = im * prev_re - re * prev_im;
      prev_re = re;
      prev_im = im;
      // Boxcar decimation (rtl_fm low_pass parity).
      acc_v += std::atan2(pi, pr);  // [-pi, pi] rad/sample
    } else {
      // AM/SSB demodulate the *decimated* complex signal
      // (rtl_fm runs low_pass before mode_demod, rtl_fm.c:762).
      acc_re += re;
      acc_im += im;
    }
    if (++acc_n < decim) return false;
    double a;
    const double dre = acc_re / decim, dim = acc_im / decim;
    switch (mode) {
      case Mode::kFm:
        a = acc_v / decim / M_PI;
        break;
      case Mode::kAm:  // envelope (am_demod, rtl_fm.c:546-561)
        a = std::sqrt(dre * dre + dim * dim);
        break;
      default: {  // kUsb/kLsb: true phasing method, I ∓ H{Q}. The
        // reference's I±Q (usb_demod/lsb_demod, rtl_fm.c:563-587) is a
        // 45° approximation with no opposite-sideband rejection.
        const int slot = (int)(ssb_n % hilbert_taps);
        ssb_i[slot] = dre;
        ssb_q[slot] = dim;
        ++ssb_n;
        double hq = 0.0;
        for (int k = 0; k < hilbert_taps; ++k) {
          // q[n-k] lives k slots behind the just-written one.
          const int idx = (slot - k + 2 * hilbert_taps) % hilbert_taps;
          hq += htaps[k] * ssb_q[idx];
        }
        const double i_delayed =
            ssb_i[(slot - (hilbert_taps - 1) / 2 + hilbert_taps) %
                  hilbert_taps];
        a = 0.5 * (mode == Mode::kUsb ? i_delayed - hq : i_delayed + hq);
        break;
      }
    }
    acc_v = acc_re = acc_im = 0.0;
    acc_n = 0;
    // De-emphasis single-pole IIR.
    if (deemph_alpha > 0.0) {
      deemph_state += deemph_alpha * (a - deemph_state);
      a = deemph_state;
    }
    // DC block (strips the AM carrier level / FM tuning offset).
    dc_avg = 0.999 * dc_avg + 0.001 * a;
    a -= dc_avg;
    const double s = a * 32767.0;
    *out = (int16_t)std::max(-32767.0, std::min(32767.0, s));
    return true;
  }
};

// Bounded producer/consumer queue for the live pipeline. Two push
// flavors: try_push (non-blocking — the USB dispatch thread must never
// wait; a full queue means the consumer fell behind and the block is
// dropped, counted) and push_wait (backpressure — the demod thread may
// wait on the writer; the slack then surfaces upstream as IQ drops).
template <typename T>
class BoundedQueue {
 public:
  explicit BoundedQueue(size_t cap) : cap_(cap) {}
  bool try_push(T v) {
    std::lock_guard<std::mutex> l(mu_);
    if (q_.size() >= cap_ || closed_) return false;
    q_.push_back(std::move(v));
    ready_.notify_one();
    return true;
  }
  void push_wait(T v) {
    std::unique_lock<std::mutex> l(mu_);
    space_.wait(l, [&] { return q_.size() < cap_ || closed_; });
    if (closed_) return;
    q_.push_back(std::move(v));
    ready_.notify_one();
  }
  // Blocks until an item or close; false = closed AND drained.
  bool pop(T* out) {
    std::unique_lock<std::mutex> l(mu_);
    ready_.wait(l, [&] { return !q_.empty() || closed_; });
    if (q_.empty()) return false;
    *out = std::move(q_.front());
    q_.pop_front();
    space_.notify_one();
    return true;
  }
  void close() {
    std::lock_guard<std::mutex> l(mu_);
    closed_ = true;
    ready_.notify_all();
    space_.notify_all();
  }

 private:
  const size_t cap_;
  std::mutex mu_;
  std::condition_variable ready_, space_;
  std::deque<T> q_;
  bool closed_ = false;
};

// One squelch-sized block of raw u8 IQ headed for the demod thread,
// with the squelch/settle verdict already made on the dispatch thread.
struct IqBlock {
  std::vector<uint8_t> bytes;
  bool mute = false;
  // Run Demod::reset() before this block: a scan hop happened on the
  // dispatch thread, and the demod state is owned by the demod thread.
  bool reset = false;
};

}  // namespace

int main(int argc, char** argv) {
  std::string mode = "fm", in_path, out_path;
  double rate = 2'000'000, live_seconds = 0, deemph_us = 75.0;
  double audio_rate = 0;  // resolved to a decim after parsing (-r/-s
                          // must not be order-dependent)
  std::vector<double> freqs;
  int audio_decim = 16;
  double squelch_level = 0.0;  // RMS threshold in u8 counts (0 = off)
  int squelch_delay = 10;      // + = mute/scan blocks, - = exit
  double gain_db = 0.0;        // 0 = leave the device default
  int ppm = 0;
  bool have_rate = false, have_audio = false;
  bool opt_dc = false, opt_deemp = false, opt_direct = false,
       opt_offset = false, opt_edge = false;
  sdrcap::BackendOptions backend;
  backend.sim_seed = 3;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = sdrcap::MakeNext(argc, argv, &i);
    if (a == "-M") mode = next();
    else if (a == "-s") { rate = sdrcap::ParseFreq(next()); have_rate = true; }
    else if (a == "-r") { audio_rate = sdrcap::ParseFreq(next()); have_audio = true; }
    else if (a == "-d") deemph_us = std::atof(next());
    else if (a == "-i") in_path = next();
    else if (a == "-f") {
      if (!sdrcap::ParseFreqSpec(next(), &freqs)) {
        std::fprintf(stderr, "bad -f spec (want hz or low:high:step)\n");
        return 2;
      }
    } else if (a == "-l") squelch_level = std::atof(next());
    else if (a == "-t") squelch_delay = std::atoi(next());
    else if (a == "-g") gain_db = std::atof(next());
    else if (a == "-p") ppm = std::atoi(next());
    else if (a == "-E") {
      std::string opt = next();
      if (opt == "dc") opt_dc = true;
      else if (opt == "deemp") opt_deemp = true;
      else if (opt == "direct") opt_direct = true;
      else if (opt == "offset") opt_offset = true;
      else if (opt == "edge") opt_edge = true;
      else { std::fprintf(stderr, "unknown -E option '%s'\n", opt.c_str()); return 2; }
    }
    else if (a == "--live") live_seconds = std::atof(next());
    else if (sdrcap::ParseBackendFlag(a, next, &backend)) {}
    else if (a == "--help") {
      std::fprintf(stderr,
                   "Usage: sdr_fm [-M fm|wbfm|am|usb|lsb|raw] [-s rate] "
                   "[-r audio_rate] [-d deemph_us] [-l squelch] "
                   "[-t squelch_delay] [-g gain_db] [-p ppm] "
                   "[-E edge|dc|deemp|direct|offset] "
                   "(-i in.iq | --live sec) [-f hz|lo:hi:step]... out.raw\n"
                   "  multiple -f with -l scans; -t<0 exits on squelch\n%s", sdrcap::BackendUsage());
      return 0;
    } else if (a[0] != '-') out_path = a;
  }
  if (mode == "wbfm") {  // rtl_fm.c:1130-1137 preset
    mode = "fm";
    if (!have_rate) rate = 170'000;
    if (!have_audio) audio_rate = 32'000;
    opt_deemp = true;
  }
  Mode m = Mode::kFm;
  if (mode == "am") m = Mode::kAm;
  else if (mode == "usb") m = Mode::kUsb;
  else if (mode == "lsb") m = Mode::kLsb;
  else if (mode == "raw") m = Mode::kRaw;
  else if (mode != "fm") {
    std::fprintf(stderr, "unknown mode '%s'\n", mode.c_str());
    return 2;
  }
  if (out_path.empty() || (in_path.empty() && live_seconds <= 0)) {
    std::fprintf(stderr, "need an input (-i or --live) and an output file\n");
    return 2;
  }
  if (freqs.empty()) freqs.push_back(100e6);
  if (freqs.size() > 1 && !in_path.empty()) {
    std::fprintf(stderr, "scanning needs a live device; using first -f only\n");
    freqs.resize(1);
  }
  const bool scanning = freqs.size() > 1;
  if (scanning && squelch_level <= 0.0) {
    std::fprintf(stderr, "scanning requires a squelch (-l)\n");  // rtl_fm.c:1166
    return 2;
  }
  FILE* out = std::fopen(out_path.c_str(), "wb");
  if (!out) { std::perror("open out"); return 1; }

  Demod dm;
  if (audio_rate > 0) audio_decim = (int)(rate / audio_rate);
  if (audio_decim < 1) audio_decim = 1;
  dm.configure(m, rate, audio_decim,
               m == Mode::kFm && (opt_deemp || deemph_us > 0) ? deemph_us : 0.0);
  uint64_t audio_samples = 0;
  // Demod's DC block is always on (it strips the AM carrier level and
  // FM tuning offset); -E dc is accepted for rtl_fm CLI parity.
  (void)opt_dc;

  // Squelch/scan state. Blocks are rtl_fm-sized (16384 bytes ≈ 4 ms at
  // 2 Msps) so scan hops have the reference's responsiveness regardless
  // of the I/O chunking above (rtl_fm.c DEFAULT_BUF_LENGTH).
  constexpr size_t kSquelchBlock = 16384;
  size_t freq_idx = 0;
  int squelch_hits = 0;
  bool exit_requested = false;
  sdrcap::Device* live_dev = nullptr;
  // Lower-edge tuning offsets the LO by rate/4 (rtl_fm.c:958-966).
  const double edge_off = opt_edge ? rate / 4.0 : 0.0;
  // When scanning, stream in squelch-block-sized device buffers and,
  // after each hop, discard the buffers the producer may have generated
  // BEFORE the retune landed (the async engine legally runs
  // num_buffers ahead — librtlsdr-style transfer queue). Without this,
  // hop decisions are made on stale-frequency data and the scanner's
  // behavior depends on a producer/consumer scheduler race.
  const size_t live_buf_len = scanning ? kSquelchBlock : 262144;
  const size_t live_num_bufs = scanning ? 2 : 8;
  int settle_blocks = 0;  // blocks to mute + skip squelch after a hop

  // Demodulate one block into `outv` (real or squelch-zeroed audio).
  // Called on the main thread (file input) or the demod thread (live).
  auto demod_to = [&](const uint8_t* data, size_t len, bool mute,
                      std::vector<int16_t>* outv) {
    int16_t s;
    for (size_t k = 0; k + 1 < len; k += 2) {
      const double re = (data[k] - 127.5) / 127.5;
      const double im = (data[k + 1] - 127.5) / 127.5;
      if (m == Mode::kRaw) {
        outv->push_back((int16_t)(re * 32767));
        outv->push_back((int16_t)(im * 32767));
      } else if (dm.push(re, im, &s)) {
        outv->push_back(mute ? 0 : s);
      }
    }
  };

  // Per-squelch-block verdict on the RAW bytes — cheap enough for the
  // USB dispatch thread. Returns 0 = play, 1 = mute, -1 = exit
  // (negative -t), 2 = scan hop performed (drop the chunk remainder —
  // it predates the hop). Device control calls stay on the calling
  // (dispatch) thread, the same serialization the 2-freq capture
  // engine's boundary retunes rely on; the demod-state reset the hop
  // needs is signaled to the demod thread through the queue instead.
  auto classify = [&](const uint8_t* data, size_t n) -> int {
    if (settle_blocks > 0) {
      --settle_blocks;
      return 1;
    }
    if (squelch_level > 0.0 && m != Mode::kRaw) {
      // RMS of the raw block in u8 counts (127.5-centered), the same
      // scale rtl_fm's rms() sees (rtl_fm.c:589-611).
      double acc = 0.0;
      for (size_t k = 0; k < n; ++k) {
        const double d = data[k] - 127.5;
        acc += d * d;
      }
      const double rms = std::sqrt(acc / (double)n);
      if (rms < squelch_level) {
        ++squelch_hits;
        if (squelch_delay < 0 && squelch_hits >= -squelch_delay)
          return -1;  // rtl_fm.c:1087-1093 (-t negative)
        if (scanning && live_dev && squelch_hits >= squelch_delay) {
          freq_idx = (freq_idx + 1) % freqs.size();
          live_dev->set_center_freq((uint32_t)(freqs[freq_idx] + edge_off));
          std::fprintf(stderr, "scan: hopping to %.0f Hz\n",
                       freqs[freq_idx]);
          squelch_hits = 0;
          settle_blocks = (int)live_num_bufs + 1;
          return 2;
        }
        return 1;
      }
      squelch_hits = 0;
    }
    return 0;
  };

  // Synchronous path (file input): classify + demod + write in line.
  auto process = [&](const uint8_t* data, size_t len) {
    std::vector<int16_t> v;
    for (size_t off = 0; off < len && !exit_requested;
         off += kSquelchBlock) {
      const size_t n = std::min(kSquelchBlock, len - off);
      const int action = classify(data + off, n);
      if (action == 2) {  // scan hop (live-only state; kept for parity)
        dm.reset();
        return;
      }
      v.clear();
      // action == -1 (exit on squelch): the closing block still flows
      // through muted — rtl_fm drains the buffer in flight on do_exit.
      demod_to(data + off, n, action != 0, &v);
      if (!v.empty()) {
        std::fwrite(v.data(), sizeof(int16_t), v.size(), out);
        audio_samples += (m == Mode::kRaw) ? v.size() / 2 : v.size();
      }
      if (action == -1) {
        exit_requested = true;
        break;
      }
    }
  };

  if (!in_path.empty()) {
    FILE* in = std::fopen(in_path.c_str(), "rb");
    if (!in) { std::perror("open in"); return 1; }
    std::vector<uint8_t> buf(1 << 16);
    size_t n;
    while ((n = std::fread(buf.data(), 1, buf.size(), in)) > 0 &&
           !exit_requested)
      process(buf.data(), n);
    std::fclose(in);
  } else {
    auto dev = sdrcap::OpenBackend(backend);
    if (!dev) return 1;
    live_dev = dev.get();
    // Real RTL2832U silicon rejects demod rates like wbfm's 170 kHz
    // (resampler constraint: (225k,300k] or (900k,3.2M]). Like rtl_fm,
    // capture at an integer multiple and boxcar-decimate back to the
    // demod rate (rtl_fm.c's capture_rate/downsample).
    int bump = 1;
    if (!dev->set_sample_rate((uint32_t)rate)) {
      uint64_t cap = (uint64_t)rate;
      while (cap <= 900'000 && bump < 64) {
        ++bump;
        cap = (uint64_t)rate * bump;
      }
      if (cap > 3'200'000 || !dev->set_sample_rate((uint32_t)cap)) {
        std::fprintf(stderr,
                     "device cannot reach %.0f Hz (tried %.0f x%d)\n",
                     rate, (double)cap, bump);
        return 1;
      }
      std::fprintf(stderr, "capturing at %.0f Hz, decimating x%d\n",
                   (double)cap, bump);
    }
    if (!dev->set_center_freq((uint32_t)(freqs[0] + edge_off))) {
      std::fprintf(stderr, "tune to %.0f Hz failed\n", freqs[0] + edge_off);
      return 1;
    }
    if (gain_db > 0) dev->set_tuner_gain_db(gain_db);
    if (ppm != 0) dev->set_freq_correction_ppm(ppm);
    if (opt_direct) dev->set_direct_sampling(2);
    if (opt_offset) dev->set_offset_tuning(true);
    // Decoupled live pipeline (rtl_fm.c:806-841 parity): the dispatch
    // thread classifies and enqueues; the demod thread computes; the
    // writer thread owns the output file. The IQ queue holds ~4 MB
    // (256 × 16 KB ≈ 1 s at 2 Msps); the audio queue backpressures the
    // demod thread so a stalled output surfaces as counted IQ drops
    // instead of unbounded memory.
    BoundedQueue<IqBlock> q_iq(256);
    BoundedQueue<std::vector<int16_t>> q_audio(64);
    uint64_t dropped_blocks = 0;  // dispatch-thread only
    bool pending_reset = false;   // dispatch-thread only

    std::thread demod_thr([&] {
      IqBlock b;
      while (q_iq.pop(&b)) {
        if (b.reset) dm.reset();
        if (b.bytes.empty()) continue;
        std::vector<int16_t> v;
        v.reserve(b.bytes.size() / (size_t)(2 * dm.decim) + 2);
        demod_to(b.bytes.data(), b.bytes.size(), b.mute, &v);
        if (!v.empty()) q_audio.push_wait(std::move(v));
      }
      q_audio.close();
    });
    std::thread writer_thr([&] {
      std::vector<int16_t> v;
      while (q_audio.pop(&v)) {
        std::fwrite(v.data(), sizeof(int16_t), v.size(), out);
        audio_samples += (m == Mode::kRaw) ? v.size() / 2 : v.size();
      }
    });

    // Boxcar complex decimator (averages `bump` consecutive IQ pairs),
    // carrying partial groups across chunks.
    std::vector<uint8_t> dec_buf;
    uint32_t carry_i = 0, carry_q = 0;
    int carry_n = 0;
    const uint64_t want_bytes = (uint64_t)(live_seconds * rate) * 2;
    uint64_t got = 0;
    dev->read_async(
        [&](const uint8_t* d, size_t len) {
          const uint8_t* data = d;
          size_t n = len;
          if (bump > 1) {
            dec_buf.clear();
            dec_buf.reserve(len / bump + 2);
            for (size_t k = 0; k + 1 < len; k += 2) {
              carry_i += d[k];
              carry_q += d[k + 1];
              if (++carry_n == bump) {
                dec_buf.push_back((uint8_t)(carry_i / (uint32_t)bump));
                dec_buf.push_back((uint8_t)(carry_q / (uint32_t)bump));
                carry_i = carry_q = 0;
                carry_n = 0;
              }
            }
            data = dec_buf.data();
            n = dec_buf.size();
          }
          for (size_t off = 0; off < n && !exit_requested;
               off += kSquelchBlock) {
            const size_t blk = std::min(kSquelchBlock, n - off);
            const int action = classify(data + off, blk);
            if (action == 2) {
              // Hop performed: the demod thread must reset its stream
              // state before the next post-hop block; the remainder of
              // this chunk predates the hop and is dropped.
              pending_reset = true;
              break;
            }
            IqBlock b;
            b.bytes.assign(data + off, data + off + blk);
            // action == -1 (exit on squelch): the closing block still
            // flows through muted — rtl_fm drains in flight on do_exit.
            b.mute = action != 0;
            b.reset = pending_reset;
            if (q_iq.try_push(std::move(b)))
              pending_reset = false;  // the reset marker is in the queue
            else
              ++dropped_blocks;  // consumer behind: drop, honestly
            if (action == -1) {
              exit_requested = true;
              break;
            }
          }
          got += n;
          if (got >= want_bytes || exit_requested) dev->cancel_async();
        },
        live_buf_len, live_num_bufs);
    q_iq.close();
    demod_thr.join();
    writer_thr.join();
    if (dropped_blocks)
      std::fprintf(stderr,
                   "dropped %llu IQ blocks (%.1f s): host demod/output "
                   "fell behind the stream\n",
                   (unsigned long long)dropped_blocks,
                   (double)dropped_blocks * kSquelchBlock / 2.0 / rate);
    if (scanning)
      std::fprintf(stderr, "scan: final frequency %.0f Hz\n", freqs[freq_idx]);
  }
  std::fclose(out);
  std::fprintf(stderr, "wrote %llu audio samples at %.0f Hz\n",
               (unsigned long long)audio_samples, rate / audio_decim);
  return 0;
}
